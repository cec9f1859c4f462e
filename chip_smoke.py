"""GPU smoke run of the PyTorch port (``splatfields_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. Device: the card's name and power limit; build the kernels (blend
   forward and backward, segment sum, fused heads forward, fused heads
   backward with its weight-gradient GEMM and its reduction) from the
   five sources in ``splatfields_torch/csrc`` with nvcc (sm_90a), one
   nvcc per source, started together.
2. Kernel vs plain on the card: the serving scene at full width (100,000
   splats from ``create_from_pcd``, VarTriPlane field model from seed 0,
   800x800, tile 16, tile_cap 1024, k_chunk 128, dup_factor 5); the
   kernel and the plain blend on one frame's own blend inputs, plus a
   heavy-overlap early-termination case, a counts > tile_cap case and
   the ``blend_case`` kinds that hold the kernels' pre-test and tile cull
   to the exact rules (thin rotated ellipses, rows whose bin box covers a
   tile their ellipse misses, alpha at 1/255 across many pixels, ragged
   counts in a permuted ``tile_ids``).
3. The slice at full width: 8 orbit frames through
   ``render_lib.render_cameras_batched``; finite outputs, the kernel's
   launch count over that run, ms/frame, the kernel's (eager and in CUDA
   graph replay) and the plain blend's ms, the kernel's bound and the
   work (``blend_work``: pairs evaluated and applied, warp-rows with an
   applied lane, rows culled).
4. A small frame rendered on the card (kernel) and on the CPU (plain
   blend) with the same weights must agree.
5. Backward kernel vs plain on the card: one training frame's own blend
   inputs and upstream gradients (captured from a training step of phase
   6's configuration), plus the early-termination and counts > tile_cap
   packs and the ``blend_case`` kinds with random upstream gradients;
   two launches on the training frame and on each kind bitwise equal.
6. The training slice at full width (``bench.py``'s default training
   workload: the serving scene's splats and net, one view per step from a
   different orbit camera, a random target, ``lambda_mask`` 0,
   ``lambda_norm`` 0.01, D-SSIM 0.2, bench.py's splat learning rates,
   field lr 1e-3): warm-up steps, then timed steps; finite losses, the
   field moved, both kernels launched once per render, ``denom`` grew;
   ms/step, rays/s, the backward kernel's (eager and in graph replay) and
   the plain version's ms, the kernel's bound and the work.
7. One small training step on the card (kernels) and on the CPU (plain
   versions) from the same weights, splats, Adam states and batch must
   agree.
8. Segment-sum kernel vs plain on the card: the sorted hash-table ids and
   gradient rows of one full-width NGP training step (captured from phase
   9's configuration), plus every ``segsum_case`` kind at D = 2 (hot
   rows, rows over many blocks, an NGP-shaped profile, out-of-range ids,
   empty rows, ragged sizes, unaligned views) and two kinds at D = 1, 3,
   4, 5 and 16; two launches must be bitwise equal, rows no id names 0.
9. The NGP training slice at full width (``bench.py --variant ngp``: the
   same splats, loss and learning rates as phase 6 with the NGPMLP field,
   16 levels of 2^20 rows): warm-up steps, then timed steps; finite
   losses, the table moved, each of the three kernels launched once per
   step; ms/step, rays/s, the segment-sum kernel's (eager and in CUDA
   graph replay), the plain version's and ``index_add_``'s ms and the
   kernel's bound.
10. One small NGP training step on the card (kernels) and on the CPU
    (plain versions) must agree as in phase 7.
11. Fused-heads kernels vs plain on the card, at f32 and bf16: both plans'
    inputs and cotangents of one full-width fused training step (phase
    12's configuration), plus a ragged N, an F = 0 plan and a plan whose
    skip input layer is its last-but-one; two backward launches must be
    bitwise equal; at bf16 both kernels also layer by layer, every value
    against the exact sum of its layer's own rounded operands
    (``check_layers``, TOL_LAYER); the weight-gradient GEMM
    (``fused_mlp_dw``) against ``fused_dw_plain`` on the step's own
    scratch, twice bitwise equal; the reduction against ``sum(0)`` at the
    step's partial shapes. In bf16
    every product of the forward and backward kernels (each layer's
    forward, the recompute, dX) and of ``fused_mlp_dw`` runs on the tensor
    cores (``mma.sync``, f32 accumulation); in f32 they are exact FMAs on
    the CUDA cores.
12. The fused slice at full width: phase 6's workload with
    ``fused_pallas="on"`` (bf16 heads): warm-up steps, then timed steps;
    finite losses, every head parameter moved, the fused forward,
    backward, dW and reduction kernels launched twice per step (deform
    and downstream plans), no ``GeneralMLP.forward`` call; then 8 serving
    frames with two forward launches each. ms/step, rays/s, ms/frame, each
    kernel's, its plain version's, its library call's and its bound's ms,
    and the heads alone, fused against the unfused GeneralMLP chain,
    forward and forward + backward.
13. One small fused training step on the card (kernels) and on the CPU
    (plain version), both at f32, must agree as in phase 7.
14. The Blender protocol's scene: an 800x800 Blender_cv dataset under
    ``build/blender_protocol`` (100 train and 4 test cameras on the orbit
    of tests/test_train_e2e.py), the ground truth rendered on the card by
    the port's ``rasterize`` from 30,000 seeded splats, alpha (1 - final
    T) as the PNGs' alpha, written through ``data/png.py``; the host's
    reader, PNG decode (filter 0 and Paeth) and 256^3 hull-carve times.
15. The 3DGS baseline through ``splatfields_torch.train.main`` with
    ``scripts/run_blender.sh``'s first command line (hull init, 10
    k-means views), cut to 300 iterations with densification at 200 and
    300 and evaluation at 1 and 300: the state on the card, one
    ``blend_fwd`` a step and per evaluation frame, one ``blend_bwd`` a
    step, densify fired, test PSNR rose, PLY and train state written;
    ms/it and the instances dropped past ``dup_cap``. Both kernels
    against their plain versions on the loop's own inputs (its last
    step's forward and backward, its last evaluation frame's forward),
    the backward twice bitwise equal.
16. SplatFields3D with the script's second command line (VarTriPlane,
    ``lambda_norm`` 0.01, init from phase 15's PLY), 30 iterations, then
    ``--resume`` to 40; the kernels on the loop's inputs as in phase 15;
    ``splatfields_torch.render.main`` on the run at 100: results.yaml's
    PSNR within the uint8 PNG round trip's bound of the loop's
    evaluation, its frames within one level of the loop's own state
    rendered here (and their PSNR within 1e-3 dB), ``deform.msgpack``
    read back equal; ms/it and the render CLI's ms/frame.
17. ``train.training`` for 3 iterations of a 64x64 scene, 3DGS and
    SplatFields3D, on the card and on the CPU with the same seeds:
    per-iteration losses within phase 7's 1e-5 relative (``card_vs_cpu``).
18. ``scripts/run_blender.sh``'s third command line (3DGS + Moran,
    ``--lambda_corr 0.01``) on phase 14's scene, 20 iterations: the
    Moran term once a step, timed by CUDA events (``CorrTimer``), its
    share of the step, the splats its KNN saw; the kernels on the loop's
    own inputs as in phase 15. Then 8 steps with ``--corr_interval 4``:
    the term, KNN included, runs at 2 of them.
19. ``splatfields_torch.extract_geo.main`` on phase 15's 3DGS and phase
    16's SplatFields3D run with ``--mesh_resolution 64``:
    ``MoransI_iteration_N.yaml`` and a mesh PLY with vertices and faces.
    3DGS: the four values within TOL_MORAN (1e-5, relative to |value| +
    0.1) of the port's on the CPU from the same saved state.
    SplatFields3D (``moran_equal_inputs``, ``phase19_failures``): the
    field outputs of the saved state card against CPU within TOL_FIELD,
    Moran's I on the CPU (its own neighbourhood weights from the card's
    positions) over the card's own neighbourhoods and outputs within
    TOL_MORAN of the report, and every neighbourhood that differs
    between the card's outputs and the CPU's a near tie
    (``neighbour_flips``); the bf16 MLP's outputs and a neighbour swapped
    for a far point must fail it.
20. ``scripts/run_dtu.sh``'s four command lines on a synthetic DTU scan
    (``write_dtu_scene``: 4 views of 1600x1200 with masks, ground truth
    rendered through the port's DTU cameras): 3DGS 50 iterations at
    ``-r 2`` (800x600, random-cube init of 100,000 points) and its render,
    SplatFields3D (``--W 128 --deform_weight 0 --pc_path``) 10
    iterations and its render; the kernels on each loop's inputs as in
    phase 15 and on its partial bottom row of tiles (600 = 37.5 tiles),
    where the backward's upstream gradient must be 0 off the image
    (``check_partial_tiles``).
21. ``card_vs_cpu`` (3 iterations) for the Moran line (the 64x64 scene)
    and the DTU 3DGS line (a 160x120 scan at ``-r 2``).
22. The render CLI with ``--lpips_weights`` (a seeded random VGG16 file,
    ``write_lpips_weights``) on phase 20's 3DGS run: results.yaml's lpips
    within 1e-4 relative of the CPU's on the same PNGs.

23. The 4-D step at full width, ``bench.py --variant owlii4d``: 100,000
    splats, VarTriPlane, rank-40 ResField layers in every head, 100
    frames, the offset flow head, 800x800, ``lambda_norm`` 0.01, a
    different fid every step, at 1 and at 5 views a step: ms/step, rays/s,
    ``blend_fwd`` and ``blend_bwd`` launched V times a step, after the
    first step (Adam from zero moments) only row ``frame`` of every
    ``weights_t`` moved and every ``matrix_t`` did, the GPU's idle share
    and top device events over 3 profiled steps; both kernels against
    their plain versions on a step's own inputs and an evaluation frame's,
    the backward twice bitwise equal.
24. A small 4-D step (``SMALL_4D``, 2,000 splats, 64x64, 2 views) on the
    card (kernels) and on the CPU (plain versions) must agree as in phase
    7.
25. ``scripts/run_owlii.sh``'s two command lines, read from the script,
    through ``splatfields_torch.train.main`` and ``render.main`` on a
    synthetic ResFields scene under ``build/owlii_protocol``
    (``write_owlii_scene``: ``OWLII_PROTOCOL_FRAMES`` frames, the
    script's ``TIME_STEP``, of 10 ``cam_train_*`` and ``cam_test`` at
    ``OWLII_RES``, ground truth rendered on the card from 30,000 seeded
    splats that move with the frame, masks from alpha): hull init of
    100,000 points, 5 views, rank 40, ``ITERS`` cut to
    ``OWLII_ITERS`` with densification at its last iteration and
    evaluation at 1 and at the end: ms/it, dup_factor growth, instances
    dropped, test PSNR rose, the reader's and the 256^3 carve's seconds,
    the loop's own iterations timed and profiled (``LoopProfile``: ms/it,
    GPU busy ms and idle share, top device events), the kernels on the
    loop's own inputs as in phase 15; the render CLI's results.yaml over
    11 x ``OWLII_PROTOCOL_FRAMES`` frames, its ms/frame and its split
    (scene load, metrics, the rest); then ``extract_geo.main`` on the run
    (fid 0, a 64^3 mesh).
26. A 3-iteration 4-D loop (``OWLII_SMALL_ARGV``: ``run_owlii.sh``'s
    flags on a 64x64, 2-frame ResFields scene, 2 views, 2,000 hull
    points) on the CPU, and on the card each iteration from the CPU's
    train state before it (``--resume``): losses within phase 7's 1e-5
    relative (``owlii_card_vs_cpu``; why not free-running there).

27. The field options one at a time on phase 6's step (its splats,
    batches, loss and learning rates, 800x800, 1 view): TriPlane (3 x 16 x
    200^2 learned planes), Grid (24 x 128^3, 50.3M entries under Adam),
    VarTriPlane with the view-dependent colour head, with
    ``geo_model_disable_pts`` and with ``n_splats`` 50,000: ms/step, the
    GPU idle share over 3 profiled steps, both blend kernels against their
    plain versions on a step's own inputs and an evaluation frame's;
    VarGridEncoder alone (no encoder key builds it into a field): forward
    and backward at the step's 100,000 points, and against the CPU.
28. The fused heads (bf16) on the plans of TriPlane (F = 48), Grid (F =
    24) and the view-dependent head (an ``mlp_rgb`` of 128 outputs, whose
    backward takes 32 points a chunk): both kernels layer by layer on a
    step's own inputs (``check_layers``, TOL_LAYER), then 2 launches of
    each fused kernel a step.
29. Phase 23's 4-D step at 1 view with VarHexPlane and per-frame conv
    deltas (after the first step, Adam from zero moments, no delta row
    moved outside the step's frame) and with HexPlane: ms/step, idle
    share, the blend kernels on a step's inputs.
30. ``run_owlii.sh``'s train line with ``--encoder_type
    VarHexPlaneEncoder --layer_strategy per_frame`` on phase 25's scene
    (cut to ``OPTION_OWLII_ITERS`` iterations and ``OPTION_OWLII_FRAMES``
    frames), then its render line with the same flags; ``run_blender.sh``'s
    SplatFields line with ``--encoder_type TriPlaneEncoder
    --use_view_dep_rgb --n_splats 50000`` on phase 14's scene (init from
    phase 15's PLY), a ``--resume`` run and the render CLI (PSNR within
    the PNG bound of the loop's): ms/it, PSNR, the kernels on each loop's
    inputs.
31. Card against CPU: ``card_vs_cpu`` for a small CLI run with TriPlane,
    the view-dependent head and ``geo_model_disable_pts``; a small static
    step with ``n_splats`` (the same subset on both) and a small 4-D
    VarHexPlane step with per-frame deltas (``SMALL_HEX``), as phase 7;
    then the step's screen gradient at every ``HEX_SEEDS`` net seed, card
    against CPU f32 and CPU f32 against CPU f64 (``hex_step``): how far
    the step's conditioning alone moves it; and the card's own attributes
    rendered on the card and on the CPU (plain blends), the renders and
    their VJP compared (``hex_equal_attributes``), a check the weights'
    margin cannot move.

32. ``scripts/run_dtu.sh``'s four command lines, read from the script,
    on a synthetic COLMAP scan (``write_colmap_scene``: a binary
    ``sparse/0`` with 49 PINHOLE cameras and ``COLMAP_POINTS`` points
    with tracks, RGBA frames of ``COLMAP_SIZE`` whose alpha is the mask),
    which ``sniff_scene_type`` reads as "Colmap": the 3DGS line (init
    from points3D.bin) and the SplatFields3D line (init from the 3DGS
    run's PLY through ``--pc_path``) at ``-r 2``, with ``ITERS`` and
    ``PC_ITER`` cut as phase 20's, the mask loss on the alpha masks, the
    kernels on each loop's inputs and partial tiles as in phase 20; both
    render lines with ``--lpips_weights`` (3 train and 25 pixelNeRF test
    views); ``extract_geo`` on the SplatFields3D run.
33. ``scripts/run_owlii.sh``'s SplatFields4D train line on a synthetic
    nerfies capture (``write_nerfies_scene``: 13 rig cameras over
    ``NERFIES_TIMES`` times at ``NERFIES_SIZE``, the moving ground truth
    of phase 25, ``NERFIES_POINTS`` DUSt3R points), ``-s`` at the vrig
    scene (the flags only the ResFields reader reads have no effect),
    ``ITERS`` cut to ``NERFIES_ITERS``: VarTriPlane, rank 40, offset flow,
    5 views; the kernels on the loop's inputs; the render CLI with
    ``--render_pred --skip_train``: the 650 frames of the spline path and
    the test set with metrics; ``extract_geo`` at fid 0.
34. ``card_vs_cpu`` for a small Colmap run (160x120, run_dtu.sh's 3DGS
    flags) and ``resumed_card_vs_cpu`` (phase 26's method) for a small
    rank-40 nerfies run (64x36, 2 times, 2 views).
35. Phase 15's command line on phase 14's scene, ``PROFILE_ITERS``
    iterations with ``--profile --watchdog_min 30``: the trace of
    iterations 21-30 exists and names both blend kernels, ten launches
    each; the watchdog's thread stops with the run.

40. ``SPLATFIELDS_MLP_BF16`` off then on (the JAX package's default for a
    static field: bf16 activations between the MLP layers) on phase 6's
    step: ms/step of each, the field's attributes on against off; phase
    7's small step with the option on, card against CPU, within the bf16
    bound of ``check_small_step_bf16``.
41. ``SPLATFIELDS_NGP_BF16_TABLE`` off then on (the JAX package's default
    off the CPU: the hash grid gathers from a bf16 copy of its table) on
    phase 9's NGP step: ms/step of each, the attributes on against off,
    the segment-sum kernel on the on-step's own rows against its plain
    version.
42. Multi-device on one card (``splatfields_torch/parallel``): (a) both
    blend kernels on each model rank's slice of a ``SLICE_RES`` training
    frame's tile grid for 2 and 4 ranks (padded starts and counts, global
    tile ids clamped to the last tile), against the plain versions and
    the whole frame; (b) ``train.main`` with ``--mesh_model 1`` (a world
    of 1 over NCCL, the sharded step) resumed from iteration 1 to
    ``MESH_ITERS`` of ``run_blender.sh``'s SplatFields3D line on phase
    14's scene, against the same run without a mesh; (c) a world of 2 spawned processes on
    the one card over gloo with CUDA tensors, a 1 x 2 mesh, one sharded
    field step against the single-device step on the same state.
43. The segment-sum kernel on the plane gradient's own rows
    (``SPLATFIELDS_PLANE_GRAD_PALLAS``): one full-width phase-6 step's
    sorted table rows of one plane (100,000 slots of 64 columns into
    160 x 160 rows) and, under ``SPLATFIELDS_QUAD_MULTI``, of all three
    (300,000 into 76,800), against the plain version within TOL_SEGSUM,
    two launches bitwise equal; the kernel's, the plain version's and
    ``index_add_``'s ms against the bytes bound; one plane's table VJP by
    each route and ``F.grid_sample``'s backward for the same gradient;
    the prefix-sum route (``SPLATFIELDS_SORTED_PLANE_GRAD``) at N =
    100,000, card against CPU, within 2 N u of the column's absolute
    running sum.
44. Every off-by-default option of the JAX package on phase 6's step
    (``PLANE_OPTIONS``: the quad sampler, its bf16 table, the multi-plane
    table, both plane-gradient routes, the packed decoder with the
    default's weights, bf16 convs, ``fuse_heads``), the default first, in
    one call; ``SPLATFIELDS_NGP_SORTED_GRAD=off`` on phase 9's; 4-D
    ``fuse_heads`` on the owlii4d step at 1 view and composition_rank 0:
    ms/step, the GPU idle share over one profiled step, the attributes'
    gap to the default (f32 options under 1e-4 of the largest value),
    blend and segment-sum launches; and each option's small step card
    against CPU as phase 7 with the decoder at 4x4 noise (bf16 options:
    ``check_small_step_bf16``).
45. Phase 37's COLMAP capture as progressive JPEG, run before phase 37
    deletes it (``progressive_phase``): each frame's twin, written with
    it by ``encode_jpeg(..., scans=JPEG_SIMPLE_PROGRESSION)`` (the same
    quantized coefficients, libjpeg's 10-scan ``jpeg_simple_progression``,
    Huffman tables from each scan's counts), decodes bit for bit to the
    baseline frame's pixels; the two decode rates in ms a megapixel; then
    ``run_dtu.sh``'s 3DGS line on the twin through ``train.main``: blend
    launches equal to its iterations, and the kernels on the loop's
    inputs and partial tiles as in phase 32.
46. ``scripts/longrun_torch.py`` (the JAX repo's ``longrun_30k.py``: the
    train loop on the seed-42 400x400 scene, SplatFields3D, 20,000 hull
    points, ``--dup_factor 64``) with its iterations cut to
    ``LONGRUN_ITERS`` and its densify start and interval cut so that a
    densify-and-prune pass falls in each of two legs, the second through
    ``--resume`` (``longrun_phase``): the legs join (the resumed
    iteration, the view order's state and ``dup_factor`` as the first
    leg saved them), blend launches equal to each leg's steps and
    evaluation frames, and the kernels on each leg's last step and
    evaluation frame against their plain versions as in phase 15.
47. One step of the 4-D quality gate's regime, card against CPU from the
    same state (``gate_step_phase``): ``scripts/quality_gate_torch.py``'s
    owlii4d scene and trainee at 400x400 with 20,000 splats at the default
    ``dup_factor`` 5, whose 100,000-row budget the untrained field
    overflows, at frame 3; the same dropped count above 0 on both, the
    step held as phase 7's, both blend kernels against their plain
    versions on the card step's inputs.

Phases 43-44 set each option themselves and refuse to run with one set
in the environment. Every phase before 40 runs with both bf16 options
off (set by ``main``):
under ``auto`` they would be on for CUDA tensors, and the earlier checks
hold f32 numerics. From phase 14 on, every call of ``train.main``,
``render.main`` and ``extract_geo.main`` starts with TF32 turned on and
must return with it off (``F32Mains``): the CLIs turn it off themselves.

The line before the last is a JSON object of the kernels (the blend
kernels' ``loop_launches``: their counts in phases 15, 16, 18, 20, 23,
25, 27, 29, 30, 32, 33, 35, 45 and 46, ``loop_max_abs_err``: their errors on
those phases' inputs, and ``partial_tile_max_abs_err`` /
``partial_tile_max_err``: their errors on phases 20, 32, 33 and 45's
partial tiles, and phases 40-42's launches; the segment sum's
``bf16_table_launches`` and ``bf16_table_max_abs_err``: phase 41's, and
its ``plane_grad_*`` keys: phase 43's errors, times and bounds on the
plane gradient and phase 44's launches there; the fused kernels'
``option_launches`` and ``option_max_layer_gap``: phase 28's); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, or with
``SPLATFIELDS_FUSED_MLP`` set (it would override each phase's choice of
head path), the script exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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
# float operations per (pixel, row) pair of the backward: ~20 to evaluate
# alpha, ~50 more for an applied row's ten partials and the prefix sums,
# and 10 adds to sum the partials over pixels
OPS_BWD_EVALUATED, OPS_BWD_APPLIED = 20, 60
# backward kernel vs plain, per column over the column's max abs: the
# per-pixel sums run in another order, and the suffix sums are totals
# minus prefixes (cancellation, ~1e-7 of the total, over 1 - alpha >=
# 0.01); a pixel whose T crosses the 1e-4 stop differently moves only its
# own rows, by about T ~ 1e-4 of a row's weight
TOL_BWD = 1e-3
TIGHT_BWD = 1e-5   # rows past this are counted and printed
# training: bench.py's splat learning rates (position, feature, opacity,
# scaling, rotation) and field learning rate; steps of phase 6
SPLAT_LRS = (1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)
FIELD_LR = 1e-3
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# bench.py --variant ngp: HiddenConfig(encoder_type="NGPMLP",
# composition_rank=0, n_frames=0), so 16 levels of 2^20 rows; phase 10's
# small net keeps 16 levels at 2^14 rows (levels 0-1 dense, the rest hashed)
NGP_HIDDEN = dict(encoder_type="NGPMLP", composition_rank=0, n_frames=0)
NGP_SMALL = dict(log2_hashmap_size=14)
# segment-sum kernel vs plain, max abs error over the column's max abs:
# the kernel sums each row in an order fixed by the slots' positions, the
# plain version's index_add_ with atomics in another order (one row of the
# NGP step takes up to a few hundred terms). Rows over LONG_ROW terms (the
# hot case's 2,053, the long rows) are held against the plain version run
# in float64 and rounded to f32: there index_add_'s own f32 order may
# drift toward 1e-5
TOL_SEGSUM = 1e-5
LONG_ROW = 2048
# segsum_case kinds, beside the NGP step's captured inputs (phase 8):
# the kernel's edges (rows over many steps and blocks, hot rows on both
# sides of a block's row edge, an NGP-shaped profile, ragged sizes,
# views off 16-byte alignment, every id out of range)
SEGSUM_KINDS = ("random", "hot", "out_of_range", "empty", "long_row_20k",
                "long_row_200k", "edge_hot", "ngp", "ragged", "unaligned",
                "all_out", "ragged_rows")
# fused heads, kernel vs plain: forward, max abs error over the output's max
# abs (per head); backward, for each gradient tensor (d_emb, d_feat, each
# layer's weight and bias), max abs error over the tensor's max abs
# ("worst") and mean abs error over mean abs ("mean"). Both sides sum the
# same rounded products in other orders (~1e-7 relative in f32). A
# pre-activation within that of 0 takes the other leaky_relu slope on one
# side, which moves its point's gradient terms by 99%: rare, so the mean
# stays near the summation-order level while the worst tensor may move by
# ~1e-2. In bf16 a sum that lands on the other side of a bf16 rounding
# boundary moves that value by one bf16 step (2^-8 relative) and the next
# layers carry it on (and may flip a later mask), hence the looser bf16
# bounds. They hold on the training step's inputs and at N = 1,037; at N =
# 100,000 random normal inputs carry enough such cascades that the worst
# point passes 0.1 under any other order, the exact one included, so the
# bf16 kernels are held there layer by layer (TOL_LAYER). Per-column
# scaling is not used: cancellation leaves some columns of dW near 0.
TOL_FUSED = {"float32": dict(fwd=1e-5, mean=1e-4, worst=5e-2),
             "bfloat16": dict(fwd=1e-2, mean=2e-2, worst=1e-1)}
# fused_mlp_dw vs fused_dw_plain on one scratch buffer, both dtypes: the
# same terms x g summed in f32 in another order. The error is taken over
# the sum of the terms' magnitudes, sum_n |x||g|, entry by entry (so an
# entry of no terms, padding included, must be exactly 0). An ordered sum
# of K terms may move by up to ~K 2^-24 of that (K = 3,456 and 11,104
# points a slice at full width); the step's correlated terms moved an f32
# entry by 1.6e-5 of it. A kernel that lost the last cp.async stage of
# each slice moves entries of that step by 0.16 of it; check_dw shows
# that every case would fail so, unless the lost points carry no terms
# (points the view's loss does not reach have zero cotangents).
TOL_DW = 1e-4
# The bf16 fused kernels layer by layer (check_layers): every rounded value
# the backward kernel keeps (each layer's input X_l and cotangent G_l),
# every forward output and d_emb / d_feat against the exact (f64) sum of
# the same layer's products of the kernels' own bf16 operands. The tensor
# cores add each k16 step of products into an f32 accumulator, so a sum
# moves by a few f32 steps of the sum of its terms' magnitudes S per k16
# step (at most ~14 x 2^-23 ~ 2e-6 of S at K = 224). A rounded value may
# differ from the exact sum rounded only where that much carries the sum
# across a bf16 rounding boundary (or a leaky_relu's 0); the least error
# that explains the value, over S, must stay within TOL_LAYER. A wrong
# index, a stale buffer or a wrong mask moves a value by its own size, far
# more. Copies (h_in, padding, the last layer's masked cotangent) must be
# exact. db must be within 2^-8 of sum |G_l| of sum G_l (it sums g, G_l is
# g rounded).
TOL_LAYER = 1e-5
ALPHA_F32 = float(np.float32(0.01))   # the kernels' leaky_relu slope
# fused-heads bounds: the bf16 dense tensor-core rate (the path's compute
# type on the card) and f32 outside the tensor cores
BF16_FLOPS = 989e12
# bench.py's heads at published widths on the VarTriPlane features (F =
# 48): build_plan configurations of the deform and downstream plans (E =
# 39)
DEFORM_CFGS = (
    dict(name="mlp_deform", emb_cols=39, hidden=128, depth=6, skips=(3,),
         out=3),)
DOWNSTREAM_CFGS = (
    dict(name="mlp_rgb", emb_cols=39, hidden=128, depth=6, skips=(3,), out=3),
    dict(name="mlp_scale", emb_cols=27, hidden=64, depth=4, skips=(2,), out=3),
    dict(name="mlp_opacity", emb_cols=21, hidden=64, depth=4, skips=(2,),
         out=1),
    dict(name="mlp_rotation", emb_cols=21, hidden=64, depth=3, skips=(20,),
         out=4))


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


def orbit_pose(theta, phi, radius):
    """A Blender (OpenGL-convention) c2w on a sphere, looking at the
    origin: ``tests/test_train_e2e.py::_make_pose``."""
    pos = radius * np.array([math.cos(phi) * math.sin(theta),
                             math.cos(phi) * math.cos(theta), math.sin(phi)])
    forward = pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, 0.0, 1.0]), forward)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1] = right, np.cross(forward, right)
    c2w[:3, 2], c2w[:3, 3] = forward, pos
    return c2w


def gt_splats(n_splats, seed, device, spread=0.5):
    """The writers' seeded ground-truth splats: means in [-spread,
    spread]^3, scales shrunk with the count, random rotations, opacities
    and colours."""
    import torch
    rng = np.random.RandomState(seed)
    scale = (300 / n_splats) ** (1 / 3)
    return {k: torch.as_tensor(v.astype(np.float32), device=device)
            for k, v in (
                ("means", rng.uniform(-spread, spread, (n_splats, 3))),
                ("scales", (0.03 + 0.04 * rng.rand(n_splats, 3)) * scale),
                ("rots", rng.randn(n_splats, 4)),
                ("ops", rng.uniform(0.5, 0.95, n_splats)),
                ("cols", rng.rand(n_splats, 3)))}


def render_gt(t, cam, width, height, shift=None):
    """One ground-truth frame of ``gt_splats`` (their means moved by
    ``shift``) through a port camera, on a white background -> the
    rasterizer's output."""
    import torch

    from splatfields_torch.ops.raster.api import rasterize
    c = cam.device_consts
    means = t["means"] if shift is None else t["means"] + shift
    return rasterize(means, t["scales"], t["rots"], t["ops"],
                     c["viewmatrix"], c["projmatrix"], c["campos"],
                     torch.ones(3, device=means.device), cam.tanfovx,
                     cam.tanfovy, width, height, colors_precomp=t["cols"],
                     tile_cap=256, k_chunk=64)


def write_blender_scene(root, res, n_train, test_thetas, device, n_splats=300,
                        seed=0, level=1):
    """A synthetic Blender_cv dataset under ``root`` (``lego``): the
    cameras of ``tests/test_train_e2e.py``'s fixture (``n_train`` on the
    phi 0.5, radius 4 orbit, fov 0.8), ground truth rendered by the port's
    ``rasterize`` on ``device`` from a seeded known splat set (the
    fixture's at its defaults), alpha (1 - final T) as the PNG's alpha,
    written through ``data/png.py``. Returns the dataset's path."""
    import json
    import os

    import torch

    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.readers.blender import (
        read_cameras_from_transforms_cv)

    root = os.path.join(str(root), "lego")
    splits = {"train": list(np.linspace(0, 2 * np.pi, n_train,
                                        endpoint=False)),
              "test": list(test_thetas)}
    blank = png.encode(np.zeros((res, res, 4), np.uint8), level=level)
    for name, thetas in splits.items():
        os.makedirs(os.path.join(root, name), exist_ok=True)
        frames = [{"file_path": f"./{name}/r_{i}",
                   "transform_matrix": orbit_pose(th, 0.5, 4.0).tolist()}
                  for i, th in enumerate(thetas)]
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
        for i in range(len(thetas)):
            with open(os.path.join(root, name, f"r_{i}.png"), "wb") as f:
                f.write(blank)

    t = gt_splats(n_splats, seed, device)
    for name in splits:
        infos, _ = read_cameras_from_transforms_cv(
            root, f"transforms_{name}.json", True)
        for i, info in enumerate(infos):
            cam = load_cam(info, -1, i, 1.0, max_resolution=res,
                           device=device)
            out = render_gt(t, cam, res, res)
            rgba = torch.cat([out.color, out.alpha]).clamp(0, 1)
            png.write(os.path.join(root, name, f"r_{i}.png"),
                      (rgba.permute(1, 2, 0).cpu().numpy() * 255).astype(
                          np.uint8), level=level)
    return root


def dtu_world_mat(theta, width, height, focal, radius):
    """One DTU ``world_mat``: K [R | t] of a camera on a circle of
    ``radius`` at height 0.35 looking at the origin (tests/
    test_protocol_scripts.py's fixture, non-square)."""
    c, s = np.cos(theta), np.sin(theta)
    center = np.array([radius * s, 0.35, radius * c], np.float32)
    fwd = -center / np.linalg.norm(center)
    right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
    right /= np.linalg.norm(right)
    r_c2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = r_c2w.T
    w2c[:3, 3] = -r_c2w.T @ center
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = focal
    k[0, 2], k[1, 2] = width / 2.0, height / 2.0
    return (k @ w2c).astype(np.float32)


def write_dtu_scene(root, width, height, n_views, device, n_splats=30_000,
                    seed=0, level=1):
    """A synthetic DTU scan under ``root`` (``scan_t``): ``cameras_sphere
    .npz`` with ``n_views`` cameras (``dtu_world_mat`` at radius 6 and a
    focal of 1.2 times the width, scale_mat 1.5: the reader's frame puts
    them 4 from the origin, outside the random-cube init's [-1.3, 1.3]^3,
    which then covers the frame, partial tiles included), RGB
    images and RGB masks, the ground truth rendered by the port's
    ``rasterize`` on ``device`` through the port's DTU reader's own
    cameras from a seeded known splat set, the mask alpha > 0.2. Returns
    the scan's path."""
    import os

    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.readers.neus import read_dtu_cameras

    root = os.path.join(str(root), "scan_t")
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    npz = {}
    blank = png.encode(np.zeros((height, width, 3), np.uint8), level=level)
    full = png.encode(np.full((height, width, 3), 255, np.uint8),
                      level=level)
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        npz[f"world_mat_{i}"] = dtu_world_mat(th, width, height,
                                              1.2 * width, 6.0)
        npz[f"scale_mat_{i}"] = np.diag([1.5, 1.5, 1.5, 1.0]).astype(
            np.float32)
        for sub, data in (("image", blank), ("mask", full)):
            with open(os.path.join(root, sub, f"{i:03d}.png"), "wb") as f:
                f.write(data)
    np.savez(os.path.join(root, "cameras_sphere.npz"), **npz)

    t = gt_splats(n_splats, seed, device, spread=0.6)
    for i, info in enumerate(read_dtu_cameras(root)):
        cam = load_cam(info, 1, i, device=device)
        out = render_gt(t, cam, width, height)
        rgb = (out.color.clamp(0, 1).permute(1, 2, 0).cpu().numpy() * 255)
        mask = (out.alpha[0] > 0.2).cpu().numpy()
        png.write(os.path.join(root, "image", f"{i:03d}.png"),
                  rgb.astype(np.uint8), level=level)
        png.write(os.path.join(root, "mask", f"{i:03d}.png"),
                  np.repeat(mask[..., None], 3, -1).astype(np.uint8) * 255,
                  level=level)
    return root


OWLII_TRAIN_CAMS = 10
OWLII_SCENE = "dancer_t"   # the scene directory write_owlii_scene makes


def write_owlii_scene(root, res, n_frames, device, n_splats=300, seed=0,
                      level=1, depth=False):
    """A synthetic ResFields (Owlii layout) scene under ``root``
    (``dancer_t``): ``cam_train_0 .. cam_train_9`` on a circle of radius 4
    at height 0.35 (``dtu_world_mat``, focal 1.1 x ``res``) and
    ``cam_test`` between two of them, each a NeuS directory of
    ``n_frames`` frames (``cameras_sphere.npz`` with identity
    ``scale_mat``, ``image/``, ``mask/`` and with ``depth`` a 16-bit
    ``depth/`` in millimetres, 0 off the mask). The ground truth is
    rendered by the port's ``rasterize`` on ``device``, through the port
    reader's own cameras, from a seeded splat set that moves 0.2 along x
    over the frames; the mask is alpha > 0.5, an 8-bit grey PNG; all PNGs
    through ``data/png.py`` (filter 0). Returns the scene's path."""
    import os

    import torch

    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.readers.neus import read_cameras_from_neus

    root = os.path.join(str(root), OWLII_SCENE)
    names = [f"cam_train_{c}" for c in range(OWLII_TRAIN_CAMS)] + [
        "cam_test"]
    thetas = [2 * np.pi * c / OWLII_TRAIN_CAMS
              for c in range(OWLII_TRAIN_CAMS)] + [np.pi / OWLII_TRAIN_CAMS]
    blank = png.encode(np.zeros((res, res, 3), np.uint8), level=level)
    t = gt_splats(n_splats, seed, device)
    for name, th in zip(names, thetas):
        cam_dir = os.path.join(root, name)
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(cam_dir, sub), exist_ok=True)
        if depth:
            os.makedirs(os.path.join(cam_dir, "depth"), exist_ok=True)
        wm = dtu_world_mat(th, res, res, 1.1 * res, 4.0)
        np.savez(os.path.join(cam_dir, "cameras_sphere.npz"), **{
            f"{k}_{f}": v for f in range(n_frames) for k, v in (
                ("world_mat", wm), ("scale_mat", np.eye(4, dtype=np.float32)))})
        for f in range(n_frames):
            with open(os.path.join(cam_dir, "image", f"{f:03d}.png"),
                      "wb") as fh:
                fh.write(blank)
        infos, _ = read_cameras_from_neus(cam_dir, True)
        for f, info in enumerate(infos):
            cam = load_cam(info, -1, f, 1.0, max_resolution=res,
                           device=device)
            shift = torch.tensor([0.2 * f / max(n_frames - 1, 1), 0.0, 0.0],
                                 device=device)
            out = render_gt(t, cam, res, res, shift)
            mask = (out.alpha[0] > 0.5).cpu().numpy()
            rgb = out.color.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
            png.write(os.path.join(cam_dir, "image", f"{f:03d}.png"),
                      (rgb * 255).astype(np.uint8), level=level)
            png.write(os.path.join(cam_dir, "mask", f"{f:03d}.png"),
                      mask.astype(np.uint8) * 255, level=level)
            if depth:
                mm = np.round(out.depth[0].cpu().numpy() * 1000) * mask
                png.write(os.path.join(cam_dir, "depth", f"{f:03d}.png"),
                          mm.astype(np.uint16), level=level)
    return root


def script_command_lines(script, env=None):
    """``scripts/<script>``'s command lines, in order, as (entry point,
    argument list) pairs, its variables expanded (``env`` overrides the
    script's defaults, as its environment would)."""
    import re
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", script)
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    env = dict(env or {})
    values = {m[1]: str(env.get(m[1], m[2])) for m in re.finditer(
        r"^(\w+)=\$\{\w+:-([^}]*)\}", text, re.M)}
    lines = []
    for line in text.splitlines():
        words = line.split()
        if words and words[0].startswith("$PY."):
            lines.append((words[0][4:], [re.sub(
                r"\$\{(\w+)\}|\$(\w+)",
                lambda m: values[m[1] or m[2]], w) for w in words[1:]]))
    return lines


def owlii_command_lines(env=None):
    """``scripts/run_owlii.sh``'s train and render command lines as
    argument lists, its variables expanded (``env`` overrides the
    script's defaults, as its environment would)."""
    lines = dict(script_command_lines("run_owlii.sh", env))
    return lines["train"], lines["render"]


def look_at_w2c(center, target=(0.0, 0.0, 0.0)):
    """OpenCV world-to-camera (R [3, 3], t [3]), float64, of a camera at
    ``center`` looking at ``target``: x right, y down (the world's +y up),
    z forward."""
    center = np.asarray(center, np.float64)
    fwd = np.asarray(target, np.float64) - center
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    r_c2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return r_c2w.T, -r_c2w.T @ center


COLMAP_SCAN = "scan_colmap"   # the scan directory write_colmap_scene makes


# a DTU scan's 49 views: the pixelNeRF split's 9 train, 15 excluded and
# 25 test ids
COLMAP_VIEWS = 49
COLMAP_TARGET = (0.0, 0.5, 0.0)   # above the object: it reaches the bottom


def colmap_pose(i):
    """The ``i``-th of the ``COLMAP_VIEWS`` cameras: a 7-wide grid of
    directions over the front of the object, as a DTU capture's arm
    covers it, at radius 3 -> the camera centre. The cameras look at
    ``COLMAP_TARGET``, so the object fills the lower part of each frame,
    its bottom row of tiles (partial at 800x600) included."""
    radius = 3.0
    cols = int(math.ceil(math.sqrt(COLMAP_VIEWS)))
    rows = int(math.ceil(COLMAP_VIEWS / cols))
    th = -0.8 + 1.6 * (i % cols) / max(cols - 1, 1)
    ph = 0.05 + 0.6 * (i // cols) / max(rows - 1, 1)
    return radius * np.array([math.cos(ph) * math.sin(th), math.sin(ph),
                              math.cos(ph) * math.cos(th)])


def _colmap_binaries(sparse, width, height, focal, poses, xyz, rgb, tracks,
                     ext=".png"):
    """COLMAP's binary model (``cameras.bin``, ``images.bin``,
    ``points3D.bin``), packed here: image ``i`` (id i + 1, camera id
    n - i, one PINHOLE camera per image, named ``<i:03d><ext>``) at
    ``poses[i]`` = (R, t), its POINTS2D the projections of the points
    whose track holds it."""
    import struct

    from splatfields_torch.data.colmap_io import rotmat2qvec
    n = len(poses)
    kmat = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]])
    seen = [[] for _ in range(n)]       # per image: (point id, x, y)
    track_idx = []
    for pid, imgs in enumerate(tracks):
        elems = []
        for i in imgs:
            R, t = poses[i]
            uvw = kmat @ (R @ xyz[pid] + t)
            elems.append((i + 1, len(seen[i])))
            seen[i].append((pid + 1, uvw[0] / uvw[2], uvw[1] / uvw[2]))
        track_idx.append(elems)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<iiQQdddd", n - i, 1, width, height, focal,
                                focal, width / 2, height / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i, (R, t) in enumerate(poses):
            f.write(struct.pack("<i4d3di", i + 1, *rotmat2qvec(R), *t,
                                n - i))
            f.write(f"{i:03d}{ext}".encode() + b"\x00")
            f.write(struct.pack("<Q", len(seen[i])))
            for pid, x, y in seen[i]:
                f.write(struct.pack("<ddq", x, y, pid))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        err = np.random.RandomState(1).rand(len(xyz))
        for pid in range(len(xyz)):
            f.write(struct.pack("<Q3d3BdQ", pid + 1, *xyz[pid], *rgb[pid],
                                err[pid], len(track_idx[pid])))
            for elem in track_idx[pid]:
                f.write(struct.pack("<ii", *elem))


def write_colmap_scene(root, width, height, device, n_splats=30_000,
                       n_points=5_000, seed=0, jpeg=False, twin=None):
    """A synthetic COLMAP scan under ``root`` (``COLMAP_SCAN``): a binary
    ``sparse/0`` (``_colmap_binaries``: ``COLMAP_VIEWS`` PINHOLE cameras at
    ``colmap_pose``, focal 1.15 x ``width``, and ``n_points`` points, the
    ground-truth means with noise and their colours, each seen by 2-4
    images) and ``images/000.png ..``, RGBA PNGs whose alpha (1 - final
    T) is the object's mask, the ground truth rendered by the port's
    ``rasterize`` on ``device`` through the port reader's own cameras
    from ``gt_splats``. With ``jpeg``: ``images/000.jpg ..``, the colour
    over black by ``encode_jpeg`` at quality 90 (no mask: the reader's
    alpha is 255), encoded on the host's cores while the next view
    renders; with ``twin`` (a directory, with ``jpeg``) the same scan under
    ``twin`` too, each frame the progressive file of the same quantized
    coefficients (``encode_jpeg(..., scans=JPEG_SIMPLE_PROGRESSION)``).
    Returns the scan's path."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.readers.colmap import _load_colmap_model

    root = os.path.join(str(root), COLMAP_SCAN)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    t = gt_splats(n_splats, seed, device, spread=0.6)
    rng = np.random.RandomState(seed + 1)
    pick = rng.choice(n_splats, min(n_points, n_splats), replace=False)
    xyz = (t["means"][pick].cpu().numpy().astype(np.float64)
           + 0.005 * rng.randn(len(pick), 3))
    rgb = (t["cols"][pick].cpu().numpy() * 255).astype(np.uint8)
    tracks = [rng.choice(COLMAP_VIEWS, rng.randint(2, 5), replace=False)
              for _ in range(len(pick))]
    poses = [look_at_w2c(colmap_pose(i), COLMAP_TARGET)
             for i in range(COLMAP_VIEWS)]
    ext = ".jpg" if jpeg else ".png"
    _colmap_binaries(sparse, width, height, 1.15 * width, poses, xyz, rgb,
                     tracks, ext)
    blank = png.encode(np.zeros((height, width, 4), np.uint8), level=1)
    for i in range(COLMAP_VIEWS):
        with open(os.path.join(root, "images", f"{i:03d}{ext}"), "wb") as f:
            f.write(blank)   # a PNG under either name, read by its bytes
    if twin is not None:
        twin = os.path.join(str(twin), COLMAP_SCAN)
        shutil.copytree(os.path.join(root, "sparse"),
                        os.path.join(twin, "sparse"))
        os.makedirs(os.path.join(twin, "images"))

    def write_jpeg(path, rgb):
        with open(path, "wb") as f:
            f.write(encode_jpeg(rgb))
        if twin is not None:
            with open(os.path.join(twin, "images", os.path.basename(path)),
                      "wb") as f:
                f.write(encode_jpeg(rgb, scans=JPEG_SIMPLE_PROGRESSION))

    jobs = []
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for i, info in enumerate(_load_colmap_model(root, "images", True)):
            cam = load_cam(info, 1, i, device=device)
            out = render_gt(t, cam, width, height)
            rgba = torch.cat([out.color, out.alpha]).clamp(0, 1).permute(
                1, 2, 0).cpu().numpy()
            rgba = (rgba * 255).astype(np.uint8)
            if jpeg:
                jobs.append(pool.submit(write_jpeg, info.image_path,
                                        rgba[..., :3]))
            else:
                png.write(info.image_path, rgba, level=1)
        for job in jobs:
            job.result()
    return root


# ITU-T T.81 Annex K: the example quantization tables (natural order) and
# Huffman tables (code counts by length 1-16, then the symbols)
JPEG_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66] + [99] * 38))
JPEG_HUFFMAN = {   # (class, id): (counts, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7, list(range(12))),
    (0, 1): ([0, 3] + [1] * 9 + [0] * 5, list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], list(
        bytes.fromhex(
            "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
            "2433627282090a161718191a25262728292a3435363738393a43444546474849"
            "4a535455565758595a636465666768696a737475767778797a83848586878889"
            "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
            "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
            "f9fa"))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], list(
        bytes.fromhex(
            "000102031104052131061241510761711322328108144291a1b1c109233352f0"
            "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
            "494a535455565758595a636465666768696a737475767778797a828384858687"
            "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
            "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
            "f9fa"))),
}
JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])


def _huffman_codes(counts, symbols):
    """{symbol: (code, length)} of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _code_arrays(codes):
    """{symbol: (code, length)} -> (code [256], length [256]) arrays."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for sym, (c, n) in codes.items():
        code[sym], length[sym] = c, n
    return code, length


def _optimal_huffman(freq):
    """(counts by length 1-16, symbols) of a Huffman table for the symbol
    counts ``freq`` [256], as T.81 K.2-K.3 build one: a pseudo-symbol of
    the lowest count takes the longest code, so no real symbol's code is
    all ones; lengths over 16 are folded back (K.3's Adjust_BITS)."""
    import heapq
    used = [s for s in range(256) if freq[s]]
    heap = [(0, 0, [256])] + [(int(freq[s]), i + 1, [s])
                              for i, s in enumerate(used)]
    heapq.heapify(heap)
    size = dict.fromkeys(used + [256], 0)
    order = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for s in a + b:
            size[s] += 1
        heapq.heappush(heap, (f1 + f2, order, a + b))
        order += 1
    bits = np.bincount(list(size.values()), minlength=33)
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1   # the pseudo-symbol's code, the last of the longest
    syms = sorted(used, key=lambda s: (size[s], s))
    return [int(b) for b in bits[1:17]], syms


def _jpeg_segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _pack_bits(vals, lens):
    """The entropy-coded bytes of codes ``vals`` of ``lens`` bits, in
    order: padded with ones, 0xFF stuffed with 0x00."""
    owner = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(len(owner)) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = (vals[owner] >> (lens[owner] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _bit_size(v):
    return np.where(v == 0, 0, np.floor(np.log2(np.maximum(
        np.abs(v), 1))).astype(np.int64) + 1)


def _amplitude(v, s):   # the value's s low bits (negatives one less)
    return np.where(v < 0, v + (1 << s) - 1, v)


# libjpeg's jpeg_simple_progression for a YCbCr frame, its scans as
# (components, Ss, Se, Ah, Al): DC and AC successive approximation
JPEG_SIMPLE_PROGRESSION = (
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0))
# the luma sampling factors (h, v) of encode_jpeg's sampling modes
JPEG_SAMPLING = {"420": (2, 2), "411": (4, 1)}


class _Tokens:
    """A scan's codes before its Huffman tables exist: each a symbol of
    table ``tbl`` (-1: raw bits alone) followed by ``nbits`` raw bits,
    emitted in the order of ``key`` (a stable sort: equal keys keep the
    order they were added in)."""

    def __init__(self):
        self.parts = []

    def add(self, key, sym, tbl, bits, nbits):
        n = len(key)
        self.parts.append([np.broadcast_to(np.asarray(a, np.int64), (n,))
                           for a in (key, sym, tbl, bits, nbits)])

    def encode(self, cls):
        """(the scan's DHT body for table class ``cls``, its bytes)."""
        key, sym, tbl, bits, nbits = (np.concatenate(a) for a in
                                      zip(*self.parts))
        o = np.argsort(key, kind="stable")
        sym, tbl, bits, nbits = sym[o], tbl[o], bits[o], nbits[o]
        vals, lens, dht = bits.copy(), nbits.copy(), b""
        for t in np.unique(tbl[tbl >= 0]):
            sel = tbl == t
            counts, syms = _optimal_huffman(np.bincount(sym[sel],
                                                        minlength=256))
            dht += bytes([cls * 16 + int(t)] + counts + syms)
            code, length = _code_arrays(_huffman_codes(counts, syms))
            s = sym[sel]
            vals[sel] = (code[s] << nbits[sel]) | bits[sel]
            lens[sel] = length[s] + nbits[sel]
        return dht, _pack_bits(vals, lens)


def _eob_runs(tok, has_eob, is_event, stride, table):
    """AC scans' end-of-band runs: the blocks with ``has_eob`` counted
    between blocks with an ``is_event`` (a code of their own), each run
    as EOBn (n = floor(log2 run), the run's n low bits after it) keyed
    before the next event block's codes, or at the scan's end. Returns
    each block's flush block."""
    events = np.flatnonzero(is_event)
    group = np.cumsum(is_event)          # a block's EOB: the next flush
    flush_at = np.append(events, len(has_eob))[group]
    runs = np.bincount(group[has_eob], minlength=len(events) + 1)
    if runs.max(initial=0) > 0x7FFF:
        raise ValueError("an EOB run over 32767 blocks")
    g = np.flatnonzero(runs)
    n = _bit_size(runs[g]) - 1
    tok.add(np.append(events, len(has_eob))[g] * stride, n * 16, table,
            runs[g] - (1 << n), n)
    return flush_at


def _progressive_scan(grids, comps, tables, mcu, ss, se, ah, al):
    """One scan of a progressive frame -> (DHT body, entropy-coded bytes):
    ``grids`` each component's quantized blocks [rows, cols, 64] (zigzag
    order, the MCU-padded grid), ``comps`` the scan's components, each of
    ``tables`` its Huffman table id, ``mcu`` (blocks (h, v) of each
    component in an MCU, (mx, my) MCUs, each component's own block
    grid). The codes are jdphuff.c's decoders' inverse (jcphuff.c's
    encode_mcu_* with EOB runs cut only between events)."""
    factors, (mx, my), own = mcu
    if len(comps) > 1:      # interleaved: MCU by MCU, each component's blocks
        parts = [grids[c].reshape(my, factors[c][1], mx, factors[c][0], 64)
                 .transpose(0, 2, 1, 3, 4).reshape(my * mx, -1, 64)
                 for c in comps]
        coef = np.concatenate(parts, 1).reshape(-1, 64)
        comp = np.tile(np.concatenate([np.full(p.shape[1], c)
                                       for c, p in zip(comps, parts)]),
                       my * mx)
    else:
        rows, cols = own[comps[0]]
        coef = grids[comps[0]][:rows, :cols].reshape(-1, 64)
        comp = np.full(len(coef), comps[0])
    tbl = np.asarray(tables)[comp]
    nb = len(coef)
    tok = _Tokens()
    if ss == 0:             # DC: differences of coef >> al, then its bits
        v = coef[:, 0] >> al
        if ah == 0:
            diff = v.copy()
            for c in comps:
                sel = comp == c
                diff[sel] = np.diff(v[sel], prepend=0)
            s = _bit_size(diff)
            tok.add(np.arange(nb), s, tbl, _amplitude(diff, s), s)
        else:
            tok.add(np.arange(nb), -1, -1, v & 1, 1)
        return tok.encode(0)
    band = coef[:, ss:se + 1]
    width = se - ss + 1
    mag = np.abs(band) >> al
    if ah == 0:             # first AC scan: run/size codes, ZRL, EOB runs
        stride = 1 + 4 * width
        val = np.sign(band) * mag
        b, j = np.nonzero(val)
        prev = np.where(np.r_[True, b[1:] != b[:-1]], -1, np.r_[0, j[:-1]])
        run = j - prev - 1
        v = val[b, j]
        s = _bit_size(v)
        last = np.full(nb, -1)
        np.maximum.at(last, b, j)
        _eob_runs(tok, last < width - 1, last >= 0, stride, tbl[0])
        zrl = np.repeat(np.arange(len(b)), run // 16)
        z = np.arange(len(zrl)) - np.repeat(np.cumsum(run // 16) - run // 16,
                                            run // 16)
        tok.add(b[zrl] * stride + 1 + 4 * j[zrl] + z, 0xF0, tbl[b[zrl]], 0, 0)
        tok.add(b * stride + 1 + 4 * j + 3, (run % 16) * 16 + s, tbl[b],
                _amplitude(v, s), s)
        return tok.encode(1)
    # refinement: each newly nonzero coefficient (+-1 << al) after its run
    # of zero-history coefficients, ZRLs that cross 16 of them, and the
    # correction bit of each coefficient already nonzero, in the segment of
    # the code the decoder reads it after (jcphuff.c's encode_mcu_AC_refine)
    new, old, zero = mag == 1, mag > 1, mag == 0
    idx = np.arange(width)
    last = np.where(new.any(1), width - 1 - np.argmax(new[:, ::-1], 1), -1)
    group = np.cumsum(new, 1) - new          # new coefficients before j
    zeros = np.cumsum(zero, 1) - zero        # zeros before j in the block
    # zeros before j within its group: minus the zeros before the group
    nb_, nj = np.nonzero(new)
    gstart = np.zeros((nb, width + 1), np.int64)   # zeros before group g
    gstart[nb_, group[nb_, nj] + 1] = zeros[nb_, nj]
    q = zeros - np.take_along_axis(gstart, group, 1)
    # each group's zeros: those before its new coefficient
    zg = np.zeros((nb, width + 1), np.int64)
    zg[nb_, group[nb_, nj]] = q[nb_, nj]
    n_zrl = zg // 16
    sub = 1 << 20
    stride = 1 << 21
    in_band = idx[None, :] <= last[:, None]
    seg = np.minimum(q // 16, np.take_along_axis(n_zrl, group, 1))
    key = (np.arange(nb)[:, None] * stride + sub
           + (group * 4 + seg) * 65)
    flush_at = _eob_runs(tok, last < width - 1, last >= 0, stride, tbl[0])
    # ZRL codes
    gb, gg = np.nonzero(n_zrl)
    rep = n_zrl[gb, gg]
    zb, zgi = np.repeat(gb, rep), np.repeat(gg, rep)
    zs = np.arange(len(zb)) - np.repeat(np.cumsum(rep) - rep, rep)
    tok.add(zb * stride + sub + (zgi * 4 + zs) * 65, 0xF0, tbl[zb], 0, 0)
    # newly nonzero coefficients: the symbol, then the sign bit
    g = group[nb_, nj]
    tok.add(nb_ * stride + sub + (g * 4 + n_zrl[nb_, g]) * 65,
            (zg[nb_, g] % 16) * 16 + 1, tbl[nb_],
            (band[nb_, nj] > 0).astype(np.int64), 1)
    # correction bits in the band up to the last new coefficient
    cb, cj = np.nonzero(old & in_band)
    tok.add(key[cb, cj] + 1 + cj, -1, -1, mag[cb, cj] & 1, 1)
    # and past it: with the block's EOB run, after the run's code
    tb, tj = np.nonzero(old & ~in_band)
    tok.add(flush_at[tb] * stride + 1, -1, -1, mag[tb, tj] & 1, 1)
    return tok.encode(1)


def encode_jpeg(rgb: np.ndarray, quality: int = 90, sampling: str = "420",
                scans=None) -> bytes:
    """A JPEG of uint8 RGB [H, W, 3] (JFIF, YCbCr, the Annex K
    quantization tables scaled to ``quality`` as libjpeg scales them), in
    NumPy: the GPU machine has no image library. Forward DCT in float64,
    chroma 4:2:0 (``sampling`` "420") or 4:1:1 ("411": luma 4x1), no
    restart markers. Baseline: one interleaved scan with the Annex K
    Huffman tables (``scans`` None). Progressive, given a ``scans`` script
    (tuples (components, Ss, Se, Ah, Al); ``JPEG_SIMPLE_PROGRESSION`` is
    libjpeg's default): SOF2 with the same quantized coefficients, each
    scan with Huffman tables built from its own symbol counts; a script
    that leaves coefficients incomplete makes a file that libjpeg-turbo
    smooths."""
    h, w = rgb.shape[:2]
    hy, vy = JPEG_SAMPLING[sampling]
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128])
    mx, my = -(-w // (8 * hy)), -(-h // (8 * vy))
    ycc = np.pad(ycc, ((0, 0), (0, 8 * vy * my - h), (0, 8 * hy * mx - w)),
                 mode="edge")
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    quant = [np.clip((q * scale + 50) // 100, 1, 255) for q in JPEG_QUANT]
    u = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * u[None] + 1) * u[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)

    def blocks(plane, q):   # [rows, cols, 64] quantized, zigzag order
        r, c = plane.shape[0] // 8, plane.shape[1] // 8
        b = (plane - 128).reshape(r, 8, c, 8).transpose(0, 2, 1, 3)
        f = dct @ b @ dct.T
        return np.round(f.reshape(r, c, 64)[..., JPEG_ZIGZAG]
                        / q[JPEG_ZIGZAG]).astype(np.int64)

    grids = [blocks(ycc[0], quant[0])] + [   # [vy my, hy mx, 64], [my, mx, 64]
        blocks(p.reshape(8 * my, vy, 8 * mx, hy).mean((1, 3)), quant[1])
        for p in ycc[1:]]
    head = b"\xff\xd8" + _jpeg_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01"
                                       b"\x00\x01\x00\x00")
    for i, q in enumerate(quant):
        head += _jpeg_segment(0xDB, bytes([i]) + bytes(
            q[JPEG_ZIGZAG].astype(np.uint8)))
    progressive = scans is not None
    head += _jpeg_segment(0xC2 if progressive else 0xC0, bytes([8]) + (
        h.to_bytes(2, "big") + w.to_bytes(2, "big")
        + bytes([3, 1, hy * 16 + vy, 0, 2, 0x11, 1, 3, 0x11, 1])))
    if progressive:
        factors = [(hy, vy), (1, 1), (1, 1)]
        own = [(-(-h // 8), -(-w // 8))] + [(-(-h // (8 * vy)),
                                             -(-w // (8 * hy)))] * 2
        body = b""
        for comps, ss, se, ah, al in scans:
            dht, data = _progressive_scan(grids, comps, (0, 1, 1),
                                          (factors, (mx, my), own),
                                          ss, se, ah, al)
            sel = b"".join(bytes([c + 1, 0 if c == 0 else 0x11])
                           for c in comps)
            body += (_jpeg_segment(0xC4, dht) if dht else b"") + \
                _jpeg_segment(0xDA, bytes([len(comps)]) + sel
                              + bytes([ss, se, ah * 16 + al])) + data
        return head + body + b"\xff\xd9"
    # baseline: per MCU the luma blocks in raster order, Cb, Cr
    yb = grids[0].reshape(my, vy, mx, hy, 64).transpose(0, 2, 1, 3, 4)
    coded = np.concatenate([yb.reshape(my * mx, vy * hy, 64)] + [
        c.reshape(my * mx, 1, 64) for c in grids[1:]], 1).reshape(-1, 64)
    comp = np.tile([0] * (vy * hy) + [1, 2], my * mx)
    dc = coded[:, 0].copy()
    for k in range(3):   # differences within each component
        sel = comp == k
        dc[sel] = np.diff(coded[sel, 0], prepend=0)
    table = np.minimum(comp, 1)
    dc_c = [_code_arrays(_huffman_codes(*JPEG_HUFFMAN[(0, t)]))
            for t in (0, 1)]
    ac_c = [_code_arrays(_huffman_codes(*JPEG_HUFFMAN[(1, t)]))
            for t in (0, 1)]
    n_blk = len(coded)
    s = _bit_size(dc)
    code = np.where(table == 0, dc_c[0][0][s], dc_c[1][0][s])
    clen = np.where(table == 0, dc_c[0][1][s], dc_c[1][1][s])
    keys = [np.arange(n_blk) * 260]
    vals = [(code << s) | _amplitude(dc, s)]
    lens = [clen + s]
    b, k = np.nonzero(coded[:, 1:])
    k = k + 1
    prev = np.where(np.r_[True, b[1:] != b[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    v = coded[b, k]
    s = _bit_size(v)
    sym = (run % 16) * 16 + s
    t = table[b]
    keys.append(b * 260 + k * 4 + run // 16)
    vals.append((np.where(t == 0, ac_c[0][0][sym], ac_c[1][0][sym]) << s)
                | _amplitude(v, s))
    lens.append(np.where(t == 0, ac_c[0][1][sym], ac_c[1][1][sym]) + s)
    zrl = np.repeat(np.arange(len(b)), run // 16)    # 16 zeros, each
    j = np.arange(len(zrl)) - np.repeat(np.cumsum(run // 16) - run // 16,
                                        run // 16)
    keys.append(b[zrl] * 260 + k[zrl] * 4 + j)
    vals.append(np.where(t[zrl] == 0, ac_c[0][0][0xF0], ac_c[1][0][0xF0]))
    lens.append(np.where(t[zrl] == 0, ac_c[0][1][0xF0], ac_c[1][1][0xF0]))
    last = np.zeros(n_blk, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 260 + 256)
    vals.append(np.where(table[eob] == 0, ac_c[0][0][0], ac_c[1][0][0]))
    lens.append(np.where(table[eob] == 0, ac_c[0][1][0], ac_c[1][1][0]))
    order = np.argsort(np.concatenate(keys), kind="stable")
    for (cls, tid), (counts, syms) in JPEG_HUFFMAN.items():
        head += _jpeg_segment(0xC4, bytes([cls * 16 + tid] + counts + syms))
    head += _jpeg_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                       0]))
    return head + _pack_bits(np.concatenate(vals)[order],
                             np.concatenate(lens)[order]) + b"\xff\xd9"


def fixed_palette_mae(frame: np.ndarray) -> float:
    """Mean absolute error, in levels a channel, of uint8 RGB ``frame``
    reduced to a fixed 256-colour palette (8 levels of red and green, 4 of
    blue, each at its interval's centre): the bound a video.gif frame's
    adaptive palette must meet against its PNG (``check_video``)."""
    step = np.array([32, 32, 64])
    approx = frame // step * step + step // 2
    return float(np.abs(approx - frame.astype(np.int64)).mean())


NERFIES_BRANCH = "vrig"      # the parent directory write_nerfies_scene makes
NERFIES_SCENE = "rig_t"      # its scene directory
NERFIES_CAMS = 13            # rig ids 0-12: every id of the spline path
NERFIES_VAL_CAM = 12
NERFIES_TARGET = (0.0, 0.35, 0.0)
# scene.json: the capture's raw frame is the reader's, shifted and scaled
NERFIES_SCALE, NERFIES_CENTER = 0.8, (0.1, -0.2, 0.3)


def nerfies_id(cam, time):
    return f"c{cam:02d}_{time:05d}"


def write_nerfies_scene(root, width, height, n_times, device, n_splats=300,
                        n_points=2_000, seed=0, scales=(1,)):
    """A synthetic nerfies multi-view capture under
    ``root/NERFIES_BRANCH/NERFIES_SCENE`` (the reader takes the dataset
    branch from the parent's name: ``vrig``, every id at 1x; link the
    scene under ``interp*`` or another name, with ``scales`` (1, 2), for
    the others): ``scene.json`` (``NERFIES_SCALE``,
    ``NERFIES_CENTER``), ``metadata.json`` (time and camera ids),
    ``dataset.json`` (ids in time order; rig cameras 0-11 train, camera 12
    val, at every time), ``camera/<id>.json`` (a rig of ``NERFIES_CAMS``
    cameras on an arc of radius 3, focal 1.1 x ``width``, positions in
    the capture's raw frame, a ``tangential`` key), ``rgb/<s>x/<id>.png``
    for each ``s`` of ``scales`` (RGB, the frame at 1/s size) and
    ``duster_points3d.ply`` (``n_points`` points about the ground truth at
    time 0, in the raw frame). The rig looks at ``NERFIES_TARGET``, so the
    object reaches the frame's bottom row of tiles (partial at 270). The
    ground truth is ``write_owlii_scene``'s: ``gt_splats`` moving 0.2
    along x over the ``n_times`` times, rendered by the port's
    ``rasterize`` on ``device`` through the port reader's own cameras.
    Returns the scene's path."""
    import json

    import torch

    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.ply import store_pointcloud
    from splatfields_torch.data.readers.nerfies import read_nerfies_cameras_mv

    root = os.path.join(str(root), NERFIES_BRANCH, NERFIES_SCENE)
    for sub in ["camera"] + [f"rgb/{s}x" for s in scales]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    center, scene_scale = np.array(NERFIES_CENTER), NERFIES_SCALE
    ids = [nerfies_id(c, f) for f in range(n_times)
           for c in range(NERFIES_CAMS)]
    meta = {nerfies_id(c, f): {"time_id": f, "camera_id": c, "warp_id": f,
                               "appearance_id": f}
            for f in range(n_times) for c in range(NERFIES_CAMS)}
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": scene_scale, "center": center.tolist(),
                   "near": 0.5, "far": 8.0}, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"count": len(ids), "num_exemplars": len(ids), "ids": ids,
                   "train_ids": [i for i in ids
                                 if meta[i]["camera_id"] != NERFIES_VAL_CAM],
                   "val_ids": [i for i in ids
                               if meta[i]["camera_id"] == NERFIES_VAL_CAM]},
                  f)
    focal = 1.1 * width
    for c in range(NERFIES_CAMS):
        th = -1.0 + 2.0 * c / (NERFIES_CAMS - 1)
        pos = np.array([3.0 * math.sin(th), 0.3 + 0.1 * (c % 3),
                        3.0 * math.cos(th)])
        rot, _ = look_at_w2c(pos, NERFIES_TARGET)
        cam = {"orientation": rot.tolist(),
               "position": (pos / scene_scale + center).tolist(),
               "focal_length": focal, "principal_point": [width / 2,
                                                          height / 2],
               "image_size": [width, height], "skew": 0.0,
               "pixel_aspect_ratio": 1.0,
               "radial_distortion": [0.0, 0.0, 0.0],
               "tangential": [0.0, 0.0]}
        for f in range(n_times):
            with open(os.path.join(root, "camera",
                                   nerfies_id(c, f) + ".json"), "w") as fh:
                json.dump(cam, fh)
    blank = png.encode(np.zeros((height, width, 3), np.uint8), level=1)
    for i in ids:
        for s in scales:
            with open(os.path.join(root, f"rgb/{s}x", i + ".png"),
                      "wb") as fh:
                fh.write(blank)

    t = gt_splats(n_splats, seed, device)
    rng = np.random.RandomState(seed + 1)
    pick = rng.choice(n_splats, n_points, replace=n_points > n_splats)
    pts = (t["means"][pick].cpu().numpy().astype(np.float64)
           + 0.01 * rng.randn(n_points, 3))
    store_pointcloud(os.path.join(root, "duster_points3d.ply"),
                     pts / scene_scale + center,
                     rng.rand(n_points, 3).astype(np.float32))
    # the reader's own cameras: the vrig branch reads every id at 1x
    for info in read_nerfies_cameras_mv(root)[0]:
        cam = load_cam(info, 1, 0, device=device)
        f = meta[info.image_name]["time_id"]
        shift = torch.tensor([0.2 * f / max(n_times - 1, 1), 0.0, 0.0],
                             device=device)
        out = render_gt(t, cam, width, height, shift)
        rgb = (out.color.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
               * 255).astype(np.uint8)
        for s in scales:
            png.write(os.path.join(root, f"rgb/{s}x", info.image_name
                                   + ".png"), rgb[::s, ::s], level=1)
    return root


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


def graph_ms(fn, iters):
    """Mean device ms of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels' time without the host's launch
    overhead, which ``cuda_ms`` includes once a call's kernels take less
    time than its Python."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
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


# blend_case kinds: the kernels' skip rules at their edges
BLEND_KINDS = ("thin", "miss", "faint", "ragged")
# rows of the "ragged" case's tiles (handed out by a permuted tile_ids)
RAGGED_COUNTS = (0, 1, 31, 33, 257, 1025, 200, 64, 0, 5, 300, 17)


def _case_rows(rng, kind, n, x0, y0, ts=16):
    """``n`` pack rows [n, 10] of one ``blend_case`` kind around the tile
    whose first pixel is (x0, y0), front to back (z increasing)."""
    if kind == "thin":       # thin ellipses at any angle, around the tile
        s1, s2 = rng.uniform(3, 40, n), rng.uniform(0.3, 1.2, n)
        mean = rng.uniform(-40, ts + 40, (n, 2))
        op = rng.uniform(0.05, 1.0, n)
    elif kind == "miss":     # just outside the tile: binned, often missed
        s1, s2 = rng.uniform(0.5, 6, n), rng.uniform(0.5, 6, n)
        side, depth = rng.randint(4, size=n), rng.uniform(0, 4, n) * s1
        along = rng.uniform(-2, ts + 2, n)
        out = np.where(side % 2 == 0, -0.5 - depth, ts - 0.5 + depth)
        mean = np.where((side < 2)[:, None], np.stack([out, along], 1),
                        np.stack([along, out], 1))
        op = rng.uniform(0.02, 1.0, n)
    elif kind == "faint":    # alpha at 1/255 across many pixels
        s1 = rng.uniform(20, 200, n)
        s2 = s1 * rng.uniform(0.5, 1.0, n)
        mean = rng.uniform(-60, ts + 60, (n, 2))
        lvl = np.float32(1 / 255)
        ring = rng.uniform(0, 30, n)   # the 1/255 level at this radius
        op = np.where(rng.rand(n) < 0.5,
                      lvl * np.exp(0.5 * (ring / s2) ** 2),
                      lvl * (1 + rng.uniform(-2e-3, 2e-3, n)))
        op[::7] = lvl
        op[1::7] = np.nextafter(lvl, np.float32(1))
        op[2::7] = np.nextafter(lvl, np.float32(0))
    else:
        raise ValueError(kind)
    th = rng.uniform(0, np.pi, n)
    cos, sin = np.cos(th), np.sin(th)
    # conic = inverse of R diag(s1^2, s2^2) R^T
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0], rows[:, 1] = x0 + mean[:, 0], y0 + mean[:, 1]
    rows[:, 2] = cos * cos * i1 + sin * sin * i2
    rows[:, 3] = cos * sin * (i1 - i2)
    rows[:, 4] = sin * sin * i1 + cos * cos * i2
    rows[:, 5] = np.minimum(op, 1.0)
    rows[:, 6:9] = rng.rand(n, 3)
    rows[:, 9] = np.linspace(0.5, 5.0, n)
    return rows


def blend_case(kind, device, seed=0, tiles_x=4, tiles_y=3, rows=240):
    """A pack that holds the blend kernels' pre-test and tile cull to the
    exact rules: "thin" (thin rotated ellipses), "miss" (splats just
    outside a tile, whose bin box covers it and whose ellipse often
    misses it), "faint" (opacities that put alpha at 1/255 across many
    pixels), "ragged" (RAGGED_COUNTS rows of mixed kinds, tiles in a
    permuted ``tile_ids``). Returns ``((pack, tile_start, counts,
    tile_ids), tiles_x, tiles_y)``."""
    import torch
    rng = np.random.RandomState(seed)
    t = tiles_x * tiles_y
    if kind == "ragged":
        counts = np.resize(np.array(RAGGED_COUNTS), t)
        tile_ids = rng.permutation(t)
    else:
        counts, tile_ids = np.full(t, rows), np.arange(t)
    parts = []
    for n, gid in zip(counts, tile_ids):
        x0, y0 = (gid % tiles_x) * 16, (gid // tiles_x) * 16
        k = (BLEND_KINDS[rng.randint(3)] if kind == "ragged" else kind)
        parts.append(_case_rows(rng, k, int(n), x0, y0))
    pack = np.concatenate(parts)
    tile_start = np.concatenate([[0], np.cumsum(counts)])

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return ((torch.as_tensor(pack, device=device), i32(tile_start),
             i32(counts), i32(tile_ids)), tiles_x, tiles_y)


def serving_blend_args(sc):
    """Phase 2's inputs: the blend's arguments of serving frame 0, exactly
    as the serving path hands them over (``tile_ids`` left to the
    default)."""
    from splatfields_torch.ops.raster import api
    from splatfields_torch.render_lib import render_camera
    captured, blend_fwd = [], api.blend_fwd

    def spy(*args):
        captured.append(args)
        return blend_fwd(*args)

    api.blend_fwd = spy
    try:
        render_camera(sc.cams[0], sc.params, sc.stats, sc.deform, sc.pipe,
                      sc.bg)
    finally:
        api.blend_fwd = blend_fwd
    (args,) = captured
    return args


def training_blend_args(sc, step, batch, lrs):
    """Phase 5's inputs: the backward kernel's arguments in one training
    step of ``step`` on ``batch`` from the scene's fresh state."""
    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster import blend_cuda
    captured, blend_bwd = [], blend_cuda.blend_bwd

    def spy(*args):
        # detached: the saved outputs come back from autograd with grad_fn
        captured.append(tuple(a.detach() if isinstance(a, torch.Tensor)
                              else a for a in args))
        return blend_bwd(*args)

    # the wrapper counts through its module-level name, the spy's here;
    # phase 6 resets the counts anyway
    spy.launches = 0
    blend_cuda.blend_bwd = spy
    try:
        step(sc.params, sc.stats, splats.adam_init(sc.params),
             sc.deform.params, sc.deform.opt_state, batch, lrs, FIELD_LR)
    finally:
        blend_cuda.blend_bwd = blend_bwd
    (bargs,) = captured
    return bargs


def training_batches(dev):
    """The phase-6 batches (warm-up, timed, and the last one, phase 5's)."""
    rng = np.random.RandomState(0)
    cams = make_views(TRAIN_WARMUP + TRAIN_STEPS + 1, RES)
    return [train_batch(c, rng, dev) for c in cams]


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


def column_errs(got, want):
    """Per column of [D, 10] gradients: max abs error over the column's
    max abs, and the rows past TIGHT_BWD."""
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    rel = (got - want).abs() / scale
    return rel.amax(dim=0), int((rel.amax(dim=1) > TIGHT_BWD).sum())


def check_bwd(label, got, want):
    import torch
    errs, loose = column_errs(got, want)
    abs_err = float((got - want).abs().max())
    print(f"{label}: max abs err {abs_err:.3e}; per column over its max "
          f"{[float(f'{e:.2e}') for e in errs]}; {loose} of {got.shape[0]} "
          f"rows past {TIGHT_BWD}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite gradient")
    if not float(errs.max()) <= TOL_BWD:
        raise AssertionError(f"{label}: column-normalised err "
                             f"{float(errs.max())} > {TOL_BWD}")
    return abs_err


def segsum_case(kind, device, d=2, seed=0):
    """Sorted int32 ids, f32 rows [M, d] and n_rows for a segment-sum
    check (``SEGSUM_KINDS``):

    - "random": 2^17 ids over 2^16 rows;
    - "hot": one row takes 2,048 slots amid 20,000 random ones;
    - "out_of_range": ids from -1,000 to n_rows + 1,000;
    - "empty": 50 ids over 2^20 rows;
    - "long_row_20k", "long_row_200k": one row takes 20,000 or 200,000
      slots amid 20,000 random ids over 4,096 rows: the row spans many of
      the kernel's steps and blocks' items;
    - "edge_hot": rows 2,047-2,049 take 9,000 slots each (more than a
      block's items), amid 20,000 random ids over 4,096 rows, so that
      blocks' row edges fall between hot rows and their items inside them;
    - "ngp": the NGP step's profile, a dense level (rows 0-999, ~160 slots
      each) then a hashed one (49,000 ids over 2^16 rows, ~1.4 a row
      touched);
    - "ragged": 100,003 ids (a prime number of slots) over 65,537 rows;
    - "unaligned": "random"'s rows as views one slot into their tensors,
      off 16-byte alignment (the kernel's scalar loads);
    - "all_out": 30,000 ids, all below 0 or at or above n_rows;
    - "ragged_rows": 1,000 ids over 100,001 rows, so blocks hold mostly
      rows and the last block's rows are ragged.

    The rows are standard normal; those of "hot", the long rows and
    "edge_hot" uniform in [0, 1): a sum of thousands of terms of mixed
    sign is ill-conditioned, and two summation orders then differ by
    ~1e-5 of the column's max, whatever the kernel does."""
    import torch
    rng = np.random.RandomState(seed)
    shift = 0
    if kind == "random":
        n_rows = 1 << 16
        ids = rng.randint(0, n_rows, 1 << 17)
    elif kind == "hot":
        n_rows = 4096
        ids = np.concatenate([rng.randint(0, n_rows, 20_000),
                              np.full(2048, 1234)])
    elif kind == "out_of_range":
        n_rows = 5000
        ids = rng.randint(-1000, n_rows + 1000, 30_000)
    elif kind == "empty":
        n_rows = 1 << 20
        ids = rng.randint(0, n_rows, 50)
    elif kind in ("long_row_20k", "long_row_200k"):
        n_rows = 4096
        ids = np.concatenate([rng.randint(0, n_rows, 20_000),
                              np.full(int(kind[9:-1]) * 1000, 1234)])
    elif kind == "edge_hot":
        n_rows = 4096
        ids = np.concatenate([rng.randint(0, n_rows, 20_000),
                              np.repeat([2047, 2048, 2049], 9000)])
    elif kind == "ngp":
        n_rows = 1 << 17
        ids = np.concatenate([np.repeat(np.arange(1000),
                                        rng.poisson(160, 1000)),
                              rng.randint(1 << 16, 1 << 17, 49_000)])
    elif kind == "ragged":
        n_rows = 65_537
        ids = rng.randint(0, n_rows, 100_003)
    elif kind == "unaligned":
        n_rows, shift = 1 << 16, 1
        ids = rng.randint(0, n_rows, (1 << 17) + shift)
    elif kind == "all_out":
        n_rows = 5000
        ids = np.concatenate([rng.randint(-1000, 0, 15_000),
                              rng.randint(n_rows, n_rows + 1000, 15_000)])
    elif kind == "ragged_rows":
        n_rows = 100_001
        ids = rng.randint(0, n_rows, 1000)
    else:
        raise ValueError(kind)
    ids = np.sort(ids).astype(np.int32)
    uniform = kind in ("hot", "long_row_20k", "long_row_200k", "edge_hot")
    vals = (rng.rand(ids.size, d) if uniform
            else rng.randn(ids.size, d)).astype(np.float32)
    return (torch.as_tensor(ids, device=device)[shift:],
            torch.as_tensor(vals, device=device)[shift:], n_rows)


def segsum_reference(sidx, vals, n_rows):
    """The plain version on the same tensors, run in float64 and rounded to
    f32 when a row takes more than LONG_ROW slots. Returns (reference,
    longest row)."""
    import torch

    from splatfields_torch.ops.segsum import sorted_segment_sum_plain
    keep = sidx[(sidx >= 0) & (sidx < n_rows)]
    longest = (int(torch.unique_consecutive(keep, return_counts=True)[1]
                   .max()) if keep.numel() else 0)
    if longest > LONG_ROW:
        want = sorted_segment_sum_plain(sidx, vals.double(), n_rows).float()
    else:
        want = sorted_segment_sum_plain(sidx, vals, n_rows)
    return want, longest


def segsum_err(got, want):
    """The worst column's max abs error over that column's max abs."""
    scale = want.abs().amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=0) / scale).max())


def check_segsum(label, sidx, vals, n_rows):
    """The kernel twice (bitwise equal) against the plain version (in
    float64 for rows over LONG_ROW slots); rows no in-range id names must
    be exactly 0. Returns the max abs error."""
    import torch

    from splatfields_torch.ops.segsum import sorted_segment_sum
    got = sorted_segment_sum(sidx, vals, n_rows)
    again = sorted_segment_sum(sidx, vals, n_rows)
    want, longest = segsum_reference(sidx, vals, n_rows)
    torch.cuda.synchronize()
    err = segsum_err(got, want)
    abs_err = float((got - want).abs().max())
    print(f"segment sum, {label}: {sidx.shape[0]} slots, {n_rows} rows, "
          f"D {vals.shape[1]}, longest row {longest}"
          f"{' (float64 reference)' if longest > LONG_ROW else ''}; max abs "
          f"err {abs_err:.3e}, worst column over its max {err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"segment sum, {label}: two launches differ")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"segment sum, {label}: non-finite output")
    if not err <= TOL_SEGSUM:
        raise AssertionError(f"segment sum, {label}: err {err} > "
                             f"{TOL_SEGSUM}")
    hit = torch.zeros(n_rows, dtype=torch.bool, device=sidx.device)
    hit[sidx[(sidx >= 0) & (sidx < n_rows)].long()] = True
    if bool(got[~hit].any()):
        raise AssertionError(f"segment sum, {label}: a row no id names is "
                             "not 0")
    return abs_err


def fused_case(kind, device, n=1037, seed=0):
    """A plan and its inputs (emb, feat, w, b, per-head cotangents) for a
    fused-heads check: "ragged" (the published-width downstream plan on n
    points, F = 48), "deform" (the published-width deform plan, F = 48),
    "no_features" (the downstream plan with F = 0) or "skip_last_but_one"
    (two heads whose skip input layer is the last-but-one). Weights as
    torch's Linear init, inputs and cotangents standard normal."""
    import torch

    from splatfields_torch.ops import fused_mlp as fm
    cfgs = DEFORM_CFGS if kind == "deform" else DOWNSTREAM_CFGS
    if kind == "skip_last_but_one":
        cfgs = (dict(name="a", emb_cols=39, hidden=64, depth=3, skips=(2,),
                     out=3),
                dict(name="b", emb_cols=21, hidden=32, depth=2, skips=(1,),
                     out=4))
    elif kind not in ("ragged", "deform", "no_features"):
        raise ValueError(kind)
    plan = fm.build_plan(cfgs, 39, 0 if kind == "no_features" else 48)
    rng = np.random.RandomState(seed)
    w = np.zeros((plan.n_rows, fm.COLS), np.float32)
    b = np.zeros((plan.n_bias, fm.COLS), np.float32)
    for head in plan.heads:
        for L in head.layers:
            bound = 1 / math.sqrt(L.fin)
            w[L.row_off:L.row_off + L.fin, :L.fout] = rng.uniform(
                -bound, bound, (L.fin, L.fout))
            b[L.bias_idx, :L.fout] = rng.uniform(-bound, bound, L.fout)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    gs = [t(rng.randn(n, h.out_dim)) for h in plan.heads]
    return (plan, t(rng.randn(n, plan.emb_dim)),
            t(rng.randn(n, plan.feat_dim)), t(w), t(b), gs)


def fused_errs(plan, got, want):
    """Backward errors as TOL_FUSED reads them, for (d_emb, d_feat, dw, db)
    tuples: {"worst", "mean"} over the gradient tensors."""
    from splatfields_torch.ops.fused_mlp import unpack_grads
    tensors = []
    for grads in (got, want):
        named = unpack_grads(grads[2], grads[3], plan)
        named.update(d_emb=grads[0], d_feat=grads[1])
        tensors.append(named)
    worst = mean = 0.0
    for k, w in tensors[1].items():
        if not w.numel() or not float(w.abs().max()) > 0:
            continue
        err = (tensors[0][k] - w).abs()
        worst = max(worst, float(err.max() / w.abs().max()))
        mean = max(mean, float(err.mean() / w.abs().mean()))
    return {"worst": worst, "mean": mean}


def check_fused(label, plan, emb, feat, w, b, gs, cdt):
    """The fused kernels (forward, backward twice: bitwise equal) against
    the plain version at compute type ``cdt``; returns the forward's and
    the backward's max abs errors."""
    import torch

    from splatfields_torch.ops import fused_mlp as fm
    with torch.no_grad():
        got = fm.fused_heads(plan, emb, feat, w, b, cdt)
        want = fm.fused_heads_plain(plan, emb, feat, w, b, cdt)
    got_b = fm.fused_heads_bwd(plan, emb, feat, w, b, gs, cdt)
    again = fm.fused_heads_bwd(plan, emb, feat, w, b, gs, cdt)
    want_b = fm.fused_heads_bwd_plain(plan, emb, feat, w, b, gs, cdt)
    torch.cuda.synchronize()
    tol = TOL_FUSED[str(cdt).split(".")[-1]]
    errs = {"fwd": max(float((g - w_).abs().max() / w_.abs().max())
                       for g, w_ in zip(got, want)),
            **fused_errs(plan, got_b, want_b)}
    abs_err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    bwd_abs = max(float((g - w_).abs().max()) if w_.numel() else 0.0
                  for g, w_ in zip(got_b, want_b))
    print(f"fused heads, {label}, {str(cdt).split('.')[-1]}: "
          f"{[h.name for h in plan.heads]}, N {emb.shape[0]}, E "
          f"{plan.emb_dim}, F {plan.feat_dim}; forward max abs err "
          f"{abs_err:.3e}; " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in errs.items()))
    for x in (*got, *got_b):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"fused heads, {label}: non-finite output")
    if not all(torch.equal(x, y) for x, y in zip(got_b, again)):
        raise AssertionError(f"fused heads, {label}: two backward launches "
                             "differ")
    for k, v in errs.items():
        if not v <= tol[k]:
            raise AssertionError(f"fused heads, {label}: {k} err {v} > "
                                 f"{tol[k]}")
    return abs_err, bwd_abs


def check_dw(label, plan, scratch, n):
    """``fused_mlp_dw`` (twice: bitwise equal; its slice partials summed
    by ``sum(0)``) against ``fused_dw_plain`` with the same slices on one
    scratch buffer, at the buffer's compute type, within TOL_DW of each
    entry's sum of term magnitudes. Also shows that the bound would catch
    a kernel that lost the last stage (32 points) of each slice. Returns
    the max abs error."""
    import torch

    from splatfields_torch.ops import fused_mlp as fm
    parts = fm.fused_dw(plan, scratch, n)
    again = fm.fused_dw(plan, scratch, n)
    slices = parts.shape[0]
    want = fm.fused_dw_plain(plan, scratch, n, slices)
    mag = fm.fused_dw_plain(plan, scratch.abs(), n, slices)
    got = parts.sum(0).view(plan.n_rows, fm.COLS)
    # the plain dW without the last 32 points of each slice
    lost = scratch.clone()
    n_pad = fm.dw_scratch_layout(plan, n).n_pad
    rows = fm.dw_slice_rows(n_pad, slices)
    for x, _ in fm.scratch_blocks(plan, lost, n):
        for s0 in range(0, n_pad, rows):
            end = min(s0 + rows, n_pad)
            x[max(s0, end - 32):end] = 0
    lost = fm.fused_dw_plain(plan, lost, n, slices)
    torch.cuda.synchronize()
    cdt = str(scratch.dtype).split(".")[-1]

    def rel(a):   # max over entries of |a - want| / sum |x||g| (0 / 0 = 0)
        return float(((a - want).abs() / mag).nan_to_num(
            nan=0.0, posinf=float("inf")).max())

    abs_err, err, lost_err = float((got - want).abs().max()), rel(got), rel(
        lost)
    print(f"fused_mlp_dw, {label}, {cdt}: {slices} slices, "
          f"{len(fm.dw_tiles(plan))} tiles, N {n}; max abs err "
          f"{abs_err:.3e}, over sum |x||g| {err:.3e} (a lost last stage of "
          f"each slice: {lost_err:.3e})")
    if not bool(torch.isfinite(parts).all()):
        raise AssertionError(f"fused_mlp_dw, {label}: non-finite output")
    if not torch.equal(parts, again):
        raise AssertionError(f"fused_mlp_dw, {label}: two launches differ")
    if not err <= TOL_DW:
        raise AssertionError(f"fused_mlp_dw, {label}: err {err} > {TOL_DW}")
    if lost_err and not lost_err > TOL_DW:
        raise AssertionError(f"fused_mlp_dw, {label}: TOL_DW would not see "
                             "a lost stage")
    return abs_err


def rounding_gaps(k, z, mag, slope=None):
    """For bf16 values ``k`` that should be rnd(s z), z exact (f64), s the
    leaky_relu slope at z's sign (``slope`` None) or the given slopes: the
    least error in z, over ``mag``, that makes a rounding give each k that
    differs from rnd(s z). Returns (how many differ, the largest such
    gap)."""
    import torch
    leaky = slope is None
    s = torch.where(z >= 0, 1.0, ALPHA_F32).to(z) if leaky else slope
    e = (s * z).float().to(torch.bfloat16)
    bad = k != e
    if not bool(bad.any()):
        return 0, 0.0
    k, e, z, s, mag = k[bad], e[bad], z[bad], s[bad], mag[bad]
    kd, ed = k.double(), e.double()
    # neighbouring bf16 values of one sign: s z had to cross their midpoint
    step = (k.view(torch.int16).int() - e.view(torch.int16).int()).abs()
    adjacent = (step == 1) & (kd * ed > 0)
    near = (s * z - (kd + ed) / 2).abs() / s
    # else (another sign, or farther): z had to reach k's unrounded value,
    # give or take half a bf16 step
    sk = torch.where(kd >= 0, 1.0, ALPHA_F32).to(kd) if leaky else s
    zk = kd / sk
    far = ((z - zk).abs() - 2.0 ** -8 * zk.abs()).clamp_min(0)
    gap = torch.where(adjacent, near, far)
    gap = torch.where(mag > 0, gap / mag, torch.full_like(gap, math.inf))
    return int(bad.sum()), float(gap.max())


def layer_witness(plan, emb, feat, w, b, gs, outs, d_emb, d_feat, scratch,
                  db):
    """The bf16 fused kernels' results held layer by layer against the
    plain sums of their own rounded operands, in f64 (TOL_LAYER's
    comment): ``outs`` the forward's per-head outputs; ``d_emb``,
    ``d_feat`` and ``scratch`` (every layer's X_l and G_l) the backward's,
    ``db`` [L, 128] its bias gradient. Raises on a value no rounding
    explains within TOL_LAYER and on an inexact copy; returns {"values":
    rounded values checked, "flips": those on the other side of a rounding
    boundary than the exact sum, "gap": the largest explaining gap}."""
    import torch

    from splatfields_torch.ops import fused_mlp as fm
    bf16, f64 = torch.bfloat16, torch.float64
    n, E = emb.shape[0], plan.emb_dim
    blocks = iter(fm.scratch_blocks(plan, scratch, n))
    st = {"values": 0, "flips": 0, "gap": 0.0}
    ref_in = torch.zeros(n, E + plan.feat_dim, dtype=f64, device=emb.device)
    mag_in = torch.zeros_like(ref_in)

    def note(what, flips, gap, values):
        st["values"] += values
        st["flips"] += flips
        st["gap"] = max(st["gap"], gap)
        if not gap <= TOL_LAYER:
            raise AssertionError(f"fused heads, {what}: a value {gap:.3e} of "
                                 "its terms' magnitudes from any rounding "
                                 f"of the exact sum (TOL_LAYER {TOL_LAYER})")

    def exact(what, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"fused heads, {what}: not exact")

    def mm(x, y):   # (x y, |x| |y|) in f64
        x, y = x.to(f64), y.to(f64)
        return x @ y, x.abs() @ y.abs()

    for hd, (head, g) in enumerate(zip(plan.heads, gs)):
        h_in = torch.cat([emb[:, :head.emb_cols], feat], 1).to(bf16)
        hin_w = h_in.shape[1]
        hl = [(L, *next(blocks)) for L in head.layers]
        ws = [w[L.row_off:L.row_off + L.fin, :L.fout].to(bf16)
              for L in head.layers]
        for j, (L, X, G) in enumerate(hl):
            name = f"{head.name} layer {j}"
            for part, blk, width in (("X", X, L.fin), ("G", G, L.fout)):
                exact(f"{name} {part} padding", blk[n:], torch.zeros_like(
                    blk[n:]))
                exact(f"{name} {part} padding", blk[:, width:],
                      torch.zeros_like(blk[:, width:]))
        exact(f"{head.name} layer 0 X (h_in)", hl[0][1][:n, :hin_w], h_in)
        # the recompute (and the forward's last layer): each layer's output
        # from the layer's own rounded input
        for j, (L, X, G) in enumerate(hl):
            bias = b[L.bias_idx, :L.fout].to(f64)
            z, mag = mm(X[:n, :L.fin], ws[j])
            z, mag = z + bias, mag + bias.abs()
            if j + 1 < len(hl):
                nxt = hl[j + 1][1][:n]
                off = hin_w if L.skip_after else 0
                if off:
                    exact(f"{head.name} layer {j + 1} X (h_in)",
                          nxt[:, :off], h_in)
                note(f"{head.name} layer {j + 1} X",
                     *rounding_gaps(nxt[:, off:off + L.fout], z, mag),
                     z.numel())
            else:
                out = outs[hd].to(f64)
                zk = torch.where(out >= 0, out, out / ALPHA_F32)
                gap = torch.where(mag > 0, (z - zk).abs() / mag,
                                  (z - zk).abs() * math.inf).nan_to_num(0.0)
                note(f"{head.name} output", 0, float(gap.max()), 0)
                # the last layer's cotangent: g through the output's mask,
                # rounded, as the kernel computes it
                exact(f"{head.name} layer {j} G", G[:n, :L.fout], torch.where(
                    outs[hd] >= 0, g, ALPHA_F32 * g).to(bf16))
        # the backward: each layer's cotangent from the next layer's, through
        # the mask of the output the kernel stored; d_h_in from layer 0's
        # dX and every skip's h_in part
        for j in range(len(hl) - 1, -1, -1):
            L, X, G = hl[j]
            dx, mag = mm(G[:n, :L.fout], ws[j].t())
            if j == 0 or hl[j - 1][0].skip_after:
                ref_in[:, :head.emb_cols] += dx[:, :head.emb_cols]
                ref_in[:, E:] += dx[:, head.emb_cols:hin_w]
                mag_in[:, :head.emb_cols] += mag[:, :head.emb_cols]
                mag_in[:, E:] += mag[:, head.emb_cols:hin_w]
            if j:
                Lp, _, Gp = hl[j - 1]
                off = hin_w if Lp.skip_after else 0
                sign = X[:n, off:off + Lp.fout] >= 0
                note(f"{head.name} layer {j - 1} G", *rounding_gaps(
                    Gp[:n, :Lp.fout], dx[:, off:off + Lp.fout],
                    mag[:, off:off + Lp.fout],
                    torch.where(sign, 1.0, ALPHA_F32).to(dx)), sign.numel())
        for j, (L, X, G) in enumerate(hl):
            gsum = G[:n, :L.fout].to(f64)
            got = db[L.bias_idx].to(f64)
            exact(f"{head.name} layer {j} db padding", got[L.fout:],
                  torch.zeros_like(got[L.fout:]))
            err = (got[:L.fout] - gsum.sum(0)).abs()
            if not bool((err <= 2.0 ** -8 * gsum.abs().sum(0)).all()):
                raise AssertionError(f"fused heads, {head.name} layer {j} "
                                     "db: off the sum of its cotangents")
    got_in = torch.cat([d_emb, d_feat], 1).to(f64)
    gap = torch.where(mag_in > 0, (got_in - ref_in).abs() / mag_in,
                      (got_in - ref_in).abs() * math.inf).nan_to_num(0.0)
    note("d_emb, d_feat", 0, float(gap.max()), 0)
    return st


def check_layers(label, plan, emb, feat, w, b, gs):
    """Both fused kernels at bf16 on the card, held layer by layer by
    ``layer_witness``; prints and returns its counts."""
    import torch

    from splatfields_torch.ops import fused_mlp as fm
    bf16 = torch.bfloat16
    with torch.no_grad():
        outs = fm.fused_heads(plan, emb, feat, w, b, bf16)
    d_emb, d_feat, scratch, b_parts = fm.launch_bwd(plan, emb, feat, w, b,
                                                    gs, bf16)
    db = b_parts.sum(0).view(plan.n_bias, fm.COLS)
    st = layer_witness(plan, emb, feat, w, b, gs, outs, d_emb, d_feat,
                       scratch, db)
    torch.cuda.synchronize()
    print(f"fused heads layer by layer, {label}, bf16: "
          f"{[h.name for h in plan.heads]}, N {emb.shape[0]}; "
          f"{st['values']} rounded values, {st['flips']} on the other side "
          "of a rounding boundary than the exact sum, the largest gap "
          f"explaining one {st['gap']:.3e} of its terms' magnitudes "
          f"(TOL_LAYER {TOL_LAYER})")
    return st


# the small 4-D field of phase 24 (and tests/test_torch_4d.py): VarTriPlane
# at noise 4x4, 4 frames, ResField rank 2 on every head, the offset flow
# head, 16-wide heads
SMALL_4D = dict(
    n_frames=4, encoder_type="VarTriPlaneEncoder",
    encoder_args={"noise_res": 4}, composition_rank=2, flow_model="offset",
    deform_w=16, deform_d=3, deform_skips=(1,), rgb_w=16, rgb_d=3,
    rgb_skips=(1,), scale_w=16, scale_d=2, scale_skips=(1,), opacity_w=16,
    opacity_d=2, opacity_skips=(1,), rotation_w=16, rotation_d=2, flow_w=16,
    flow_d=3, flow_skips=(1,))


def small_4d_net(device, seed=0, **kw):
    """``SMALL_4D``'s port net (or ``kw``'s), weights from ``seed``, on
    ``device``."""
    import torch

    from splatfields_torch.models.splatfields import SplatFields
    return SplatFields(**(kw or SMALL_4D),
                       generator=torch.Generator().manual_seed(seed)).to(
                           device)


def ngp_model(device=None, **small):
    """bench.py --variant ngp's field model (seed 0), or a smaller one."""
    from splatfields_torch import config
    from splatfields_torch.models.deform_model import DeformModel
    return DeformModel(config.HiddenConfig(**{**NGP_HIDDEN, **small}),
                       radius=1.0, seed=0, device=device)


def train_batch(cam, rng, device):
    """One view's batch for make_train_step: a random target image."""
    import torch
    res = cam.image_width

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {"viewmatrix": f32(cam.world_view_transform)[None],
            "projmatrix": f32(cam.full_proj_transform)[None],
            "campos": f32(cam.camera_center)[None],
            "tanfovx": [cam.tanfovx], "tanfovy": [cam.tanfovy], "fid": 0.0,
            "image": f32(rng.rand(1, 3, res, res)), "bg": f32(np.ones(3))}


def train_step_fn(deform, pipe, res):
    """bench.py's default training step (field mode, one view)."""
    from splatfields_torch import config, train_lib
    opt = config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01)
    return train_lib.make_train_step(deform.net, opt, pipe, res, res, 1,
                                     True, 0, 0)


def nonzero_adam(tree, seed):
    """An Adam state with count 10 and moments from a numpy seed (so a
    step's update is a smooth function of the gradient)."""
    import torch

    from splatfields_torch.models import splats
    rng = np.random.RandomState(seed)
    items = splats.tree_items(tree)

    def draw(scale, lo=None):
        return splats.tree_like(tree, {
            k: torch.as_tensor((rng.randn(*v.shape) * scale if lo is None else
                                rng.uniform(lo, 1.5, v.shape) * scale
                                ).astype(np.float32), device=v.device)
            for k, v in items.items()})

    return splats.AdamState(count=10, mu=draw(1e-3), nu=draw(1e-6, 0.5))


def train_phases(sc, dev, smi):
    """Phases 5-7; returns the backward kernel's entry of the kernels
    line. ``smi`` is the card's name and power limit."""
    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.raster import blend_cuda
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.raster.blend_torch import (
        blend_bwd_plain,
        blend_work,
    )

    step = train_step_fn(sc.deform, sc.pipe, RES)
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    batches = training_batches(dev)

    # --- 5. backward kernel vs plain ---------------------------------------
    bargs = training_blend_args(sc, step, batches[-1], lrs)
    ts, tc, tk = 16, 1024, 128
    plain_args = (*bargs[:10], bargs[10], ts, tc, tk)
    got = blend_bwd(*bargs)
    torch.cuda.synchronize()
    bwd_err = check_bwd("backward, training frame", got,
                        blend_bwd_plain(*plain_args))
    if not float(got.abs().max()) > 0:
        raise AssertionError("backward of the training frame is all zero")
    if not torch.equal(blend_bwd(*bargs), got):
        raise AssertionError("two blend_bwd launches differ")

    def synthetic_bwd(label, rows, opacity):
        (pack, start, counts), tx, ty = synthetic_pack(dev, rows, opacity)
        tile_ids = torch.arange(tx * ty, device=dev, dtype=torch.int32)
        out = blend_fwd(pack, start, counts, tx, ty, ts, tc, tk)
        g = np.random.RandomState(rows)
        gs = [torch.as_tensor(g.rand(*o.shape).astype(np.float32),
                              device=dev) for o in out]
        args = (pack, start, counts, tile_ids, *gs, *out)
        check_bwd(label, blend_bwd(*args, tx, ts, tc),
                  blend_bwd_plain(*args, tx, ts, tc, tk))
        return out

    out = synthetic_bwd("backward, early termination", 600, 0.9)
    if not float(out[2].max()) < 1e-2:
        raise AssertionError("early-termination case did not saturate")
    out = synthetic_bwd("backward, counts > tile_cap", 1500, 0.005)
    if not float(out[2].min()) > 1e-4:
        raise AssertionError("tile_cap case stopped early: cap untested")
    for kind in BLEND_KINDS:
        (pack, start, counts, ids), tx, ty = blend_case(kind, dev)
        out = blend_fwd(pack, start, counts, tx, ty, ts, tc, tk, ids)
        g = np.random.RandomState(1)
        gs = [torch.as_tensor(g.rand(*o.shape).astype(np.float32),
                              device=dev) for o in out]
        args = (pack, start, counts, ids, *gs, *out)
        got = blend_bwd(*args, tx, ts, tc)
        check_bwd(f"backward, {kind} case", got,
                  blend_bwd_plain(*args, tx, ts, tc, tk))
        if not torch.equal(blend_bwd(*args, tx, ts, tc), got):
            raise AssertionError(f"{kind} case: two blend_bwd launches "
                                 "differ")

    # --- 6. the training slice at full width -------------------------------
    sp, st = sc.params, sc.stats
    sopt, fp, fopt = splats.adam_init(sp), sc.deform.params, sc.deform.opt_state
    fp0 = {k: v.clone() for k, v in fp.items()}
    losses = []
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for i, b in enumerate(batches[:TRAIN_WARMUP + TRAIN_STEPS]):
        if i == TRAIN_WARMUP:
            start.record()
        sp, st, sopt, fp, fopt, out = step(sp, st, sopt, fp, fopt, b, lrs,
                                           FIELD_LR)
        losses.append(out.loss)
    end.record()
    torch.cuda.synchronize()
    renders = TRAIN_WARMUP + TRAIN_STEPS
    fwd_launches, bwd_launches = blend_fwd.launches, blend_bwd.launches
    if (fwd_launches, bwd_launches) != (renders, renders):
        raise AssertionError(f"{renders} renders launched blend_fwd "
                             f"{fwd_launches} and blend_bwd {bwd_launches} "
                             "times")
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    moved = max(float((fp[k] - fp0[k]).abs().max()) for k in fp)
    if not moved > 0:
        raise AssertionError("the field parameters did not move")
    visible = out.radii > 0
    if not (bool(visible.any()) and bool((st.denom[visible] >= 1).all())
            and float(st.denom.max()) <= renders):
        raise AssertionError("denom did not grow for the visible splats")
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    print("training losses:", [round(x, 6) for x in losses.tolist()])
    print(f"field moved by up to {moved:.3e}; splats seen: "
          f"{int((st.denom > 0).sum())}; bin_dropped last step "
          f"{int(out.loss_dict['bin_dropped'])}")
    print(f"train ms/step {step_ms:.4f}; rays/s {RES * RES / step_ms * 1e3:.1f} "
          f"({RES}x{RES}, {N_SPLATS} splats, 1 view, {TRAIN_STEPS} steps after "
          f"{TRAIN_WARMUP} warm-up; blend_fwd {fwd_launches} and blend_bwd "
          f"{bwd_launches} launches for {renders} renders; {smi})")

    kernel_ms = cuda_ms(lambda: blend_bwd(*bargs), 50)
    graph_kernel_ms = graph_ms(lambda: blend_bwd(*bargs), 50)
    plain_ms = cuda_ms(lambda: blend_bwd_plain(*plain_args), 3)
    pack, tile_start, counts = bargs[:3]
    work = blend_work(pack, tile_start, counts, bargs[10], ts, tc, tk,
                      bargs[3])
    evaluated, applied = work.evaluated, work.applied
    n_tiles, p = counts.shape[0], ts * ts
    # pack read and grad written once, tile arrays, ten floats per pixel
    bytes_moved = (2 * pack.numel() * 4 + (tile_start.numel() + 2 * n_tiles)
                   * 4 + n_tiles * 10 * p * 4)
    ops = OPS_BWD_EVALUATED * evaluated + OPS_BWD_APPLIED * applied
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    print(f"blend_bwd: kernel {kernel_ms:.5f} ms, graph replay "
          f"{graph_kernel_ms:.5f} ms, plain {plain_ms:.4f} ms; "
          f"sorted_pack {tuple(pack.shape)}, {n_tiles} tiles; "
          f"{evaluated} pairs evaluated, {applied} applied, "
          f"{work.warp_rows} warp-rows with an applied lane, {work.culled} "
          f"of {int(counts.clamp(max=tc).sum())} tile rows culled; {ops} "
          f"operations, {bytes_moved} bytes; bytes bound {bytes_ms:.5f} ms, "
          f"ops bound {ops_ms:.5f} ms")

    # --- 7. small step: kernels on the card vs plain versions on the CPU -----
    cam = make_views(2, 64)[1]
    pipe = sc.pipe
    res = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        p_, s_ = splats.create_from_pcd(sc.pts[:2000], sc.cols[:2000], 0,
                                        device=device)
        d_ = DeformModel(sc.hidden, radius=1.0, seed=0, device=device)
        res[name] = train_step_fn(d_, pipe, 64)(
            p_, s_, nonzero_adam(p_, 1), d_.params, nonzero_adam(d_.params, 2),
            train_batch(cam, np.random.RandomState(1), device), lrs,
            FIELD_LR)
    check_small_step(res["cuda"], res["cpu"])

    return {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "splatfields_torch/csrc/blend_bwd.cu",
        "replaces": "splatfields_tpu/ops/raster/blend_pallas.py:443",
        "launches": bwd_launches,
        "max_abs_err": bwd_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "graph_ms": graph_kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        # no single PyTorch call computes this VJP
        "library_ms": None,
    }


def capture_table_vjp(sc, deform, step, batch, lrs):
    """One NGP training step (``step`` from ``train_step_fn``) with the
    table VJP's inputs captured as it meets them: ``(ids, g)`` handed to
    ``encoders._sort_rows`` and ``(sidx, rows, n_rows)`` handed to
    ``sorted_segment_sum``."""
    from splatfields_torch.models import encoders, splats
    sort_rows, segsum = encoders._sort_rows, encoders.sorted_segment_sum
    sorts, sums = [], []

    def sort_spy(ids, rows):
        sorts.append((ids.detach(), rows.detach()))
        return sort_rows(ids, rows)

    def segsum_spy(sidx, vals, n_rows):
        sums.append((sidx.detach(), vals.detach(), n_rows))
        return segsum(sidx, vals, n_rows)

    encoders._sort_rows, encoders.sorted_segment_sum = sort_spy, segsum_spy
    try:
        step(sc.params, sc.stats, splats.adam_init(sc.params), deform.params,
             deform.opt_state, batch, lrs, FIELD_LR)
    finally:
        encoders._sort_rows, encoders.sorted_segment_sum = sort_rows, segsum
    (sort_args,), (sum_args,) = sorts, sums
    return sort_args, sum_args


def ngp_phases(sc, dev, smi):
    """Phases 8-10; returns the segment-sum kernel's entry of the kernels
    line."""
    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.segsum import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    deform = ngp_model(dev)
    step = train_step_fn(deform, sc.pipe, RES)
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    rng = np.random.RandomState(0)
    cams = make_views(TRAIN_WARMUP + TRAIN_STEPS + 1, RES)
    batches = [train_batch(c, rng, dev) for c in cams]

    # --- 8. segment-sum kernel vs plain ------------------------------------
    _, cap = capture_table_vjp(sc, deform, step, batches[-1], lrs)
    sidx, vals, n_rows = cap
    table = deform.params["encoder.encoding.table"]
    if (n_rows != table.shape[0] * table.shape[1]
            or tuple(vals.shape) != (sidx.shape[0], table.shape[2])):
        raise AssertionError(f"captured segment sum: {tuple(sidx.shape)}, "
                             f"{tuple(vals.shape)}, {n_rows} rows")
    seg_err = check_segsum("NGP training step", *cap)
    if not float(vals.abs().max()) > 0:
        raise AssertionError("the NGP step's table gradient rows are zero")
    for kind in SEGSUM_KINDS:
        check_segsum(kind, *segsum_case(kind, dev))
    for d in (1, 3, 4, 5, 16):
        for kind in ("ngp", "unaligned"):
            check_segsum(f"{kind}, D {d}", *segsum_case(kind, dev, d=d))

    # --- 9. the NGP training slice at full width ---------------------------
    sp, st = sc.params, sc.stats
    sopt, fp, fopt = splats.adam_init(sp), deform.params, deform.opt_state
    table0 = fp["encoder.encoding.table"].clone()
    losses = []
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = sorted_segment_sum.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for i, b in enumerate(batches[:TRAIN_WARMUP + TRAIN_STEPS]):
        if i == TRAIN_WARMUP:
            start.record()
        sp, st, sopt, fp, fopt, out = step(sp, st, sopt, fp, fopt, b, lrs,
                                           FIELD_LR)
        losses.append(out.loss)
    end.record()
    torch.cuda.synchronize()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    launches = (blend_fwd.launches, blend_bwd.launches,
                sorted_segment_sum.launches)
    if launches != (steps,) * 3:
        raise AssertionError(f"{steps} NGP steps launched blend_fwd, "
                             f"blend_bwd and sorted_segment_sum {launches} "
                             "times")
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite NGP loss: {losses.tolist()}")
    moved = float((fp["encoder.encoding.table"] - table0).abs().max())
    if not moved > 0:
        raise AssertionError("the hash table did not move")
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    print("NGP training losses:", [round(x, 6) for x in losses.tolist()])
    print(f"NGP table moved by up to {moved:.3e}; splats seen: "
          f"{int((st.denom > 0).sum())}; bin_dropped last step "
          f"{int(out.loss_dict['bin_dropped'])}")
    print(f"NGP train ms/step {step_ms:.4f}; rays/s "
          f"{RES * RES / step_ms * 1e3:.1f} ({RES}x{RES}, {N_SPLATS} splats, "
          f"table {tuple(table0.shape)}, 1 view, {TRAIN_STEPS} steps after "
          f"{TRAIN_WARMUP} warm-up; blend_fwd, blend_bwd, sorted_segment_sum "
          f"launches {launches} for {steps} steps; {smi})")

    d = vals.shape[1]
    kernel_ms = cuda_ms(lambda: sorted_segment_sum(*cap), 20)
    graph_kernel_ms = graph_ms(lambda: sorted_segment_sum(*cap), 20)
    plain_ms = cuda_ms(lambda: sorted_segment_sum_plain(*cap), 5)
    library_ms = cuda_ms(lambda: torch.zeros(n_rows, d, device=dev).index_add_(
        0, sidx, vals), 5)
    # ids and rows read once, every output row written once; one add a value
    bytes_moved = sidx.numel() * 4 + vals.numel() * 4 + n_rows * d * 4
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = vals.numel() / F32_FLOPS * 1e3
    print(f"sorted_segment_sum: kernel {kernel_ms:.5f} ms (the wrapper: one "
          f"launch, which finds its own block ranges), graph replay "
          f"{graph_kernel_ms:.5f} ms, plain {plain_ms:.5f} ms, index_add_ "
          f"{library_ms:.5f} ms; {sidx.numel()} slots, {n_rows} rows, D {d}; "
          f"{bytes_moved} bytes, bytes bound {bytes_ms:.5f} ms, ops bound "
          f"{ops_ms:.7f} ms")

    # --- 10. small NGP step: kernels on the card vs plain on the CPU --------
    cam = make_views(2, 64)[1]
    res = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        p_, s_ = splats.create_from_pcd(sc.pts[:2000], sc.cols[:2000], 0,
                                        device=device)
        d_ = ngp_model(device, **NGP_SMALL)
        res[name] = train_step_fn(d_, sc.pipe, 64)(
            p_, s_, nonzero_adam(p_, 1), d_.params, nonzero_adam(d_.params, 2),
            train_batch(cam, np.random.RandomState(1), device), lrs,
            FIELD_LR)
    check_small_step(res["cuda"], res["cpu"])

    return {
        "name": "sorted_segment_sum",
        "route": "cuda",
        "source": "splatfields_torch/csrc/segsum.cu",
        "replaces": "splatfields_tpu/ops/segsum_pallas.py:110",
        "launches": launches[2],
        "max_abs_err": seg_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "graph_ms": graph_kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": library_ms,
    }


def heads_flops(plans, n):
    """Multiply-adds x 2 of the plans' forward on n points."""
    return 2 * n * sum(L.fin * L.fout for plan in plans for h in plan.heads
                       for L in h.layers)


def fused_phases(sc, dev, smi):
    """Phases 11-13; returns the kernels-line entries of the fused
    forward, backward and reduction kernels."""
    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.models.mlp import GeneralMLP
    from splatfields_torch.ops import fused_mlp as fm
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.render_lib import (
        render_camera,
        render_cameras_batched,
    )

    bf16 = torch.bfloat16
    net = sc.deform.net
    net.fused_pallas = "on"   # bf16 on the card, as the JAX package runs it
    step = train_step_fn(sc.deform, sc.pipe, RES)
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    rng = np.random.RandomState(0)
    cams = make_views(TRAIN_WARMUP + TRAIN_STEPS + 1, RES)
    batches = [train_batch(c, rng, dev) for c in cams]

    # --- 11. fused kernels vs plain -----------------------------------------
    captured = []
    fused_bwd = fm.fused_heads_bwd

    def spy(plan, emb, feat, w, b, gs, cdt):
        captured.append((plan, emb.detach(), feat.detach(), w.detach(),
                         b.detach(), [g.detach() for g in gs]))
        if cdt != bf16:
            raise AssertionError(f"the fused step ran in {cdt}")
        return fused_bwd(plan, emb, feat, w, b, gs, cdt)

    # the backward counts through its module-level name, the spy's here;
    # phase 12 resets the counts anyway
    spy.launches = 0
    fm.fused_heads_bwd = spy
    try:
        step(sc.params, sc.stats, splats.adam_init(sc.params),
             sc.deform.params, sc.deform.opt_state, batches[-1], lrs,
             FIELD_LR)
    finally:
        fm.fused_heads_bwd = fused_bwd
    plans = {c[0].heads[0].name: c for c in captured}
    if len(captured) != 2 or set(plans) != {"mlp_deform", "mlp_rgb"}:
        raise AssertionError("the fused step's backward ran for "
                             f"{[c[0].heads[0].name for c in captured]}")
    cases = [plans["mlp_deform"], plans["mlp_rgb"]]
    fwd_err, bwd_err = 0.0, 0.0
    for case in cases:
        for cdt in (torch.float32, bf16):
            errs = check_fused(f"training step, {case[0].heads[0].name}",
                               *case, cdt)
            if cdt == bf16:
                fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err,
                                                              errs[1])
        if not float(case[5][0].abs().max()) > 0:
            raise AssertionError("the fused step's cotangents are zero")
        check_layers(f"training step, {case[0].heads[0].name}", *case)
    for kind in ("ragged", "no_features", "skip_last_but_one"):
        case = fused_case(kind, dev)
        for cdt in (torch.float32, bf16):
            check_fused(kind, *case, cdt)
            check_dw(kind, case[0], fm.launch_bwd(*case, cdt)[2],
                     case[1].shape[0])
        check_layers(kind, *case)
    # the weight-gradient GEMM on the step's own scratch (the backward
    # kernel's output for the step's inputs); the bf16 scratch and
    # partials are kept for phase 12's timings
    n = sc.params.xyz.shape[0]
    dw_err, scratches, dw_parts, b_parts = 0.0, [], [], []
    for case in cases:
        for cdt in (torch.float32, bf16):
            _, _, scratch, b_part = fm.launch_bwd(*case, cdt)
            err = check_dw(f"training step, {case[0].heads[0].name}",
                           case[0], scratch, n)
            if cdt == bf16:
                dw_err = max(dw_err, err)
                scratches.append(scratch)
                dw_parts.append(fm.fused_dw(case[0], scratch, n))
                b_parts.append(b_part)
    # the reduction at the step's partial shapes, random values
    red_err = 0.0
    for i, (pw, pb) in enumerate(zip(dw_parts, b_parts)):
        rng = np.random.RandomState(i)
        pw, pb = (torch.as_tensor(rng.randn(*p.shape).astype(np.float32),
                                  device=dev) for p in (pw, pb))
        got = fm.reduce_partials(pw, pb)
        again = fm.reduce_partials(pw, pb)
        want = (pw.sum(0), pb.sum(0))
        torch.cuda.synchronize()
        for g, a, w_ in zip(got, again, want):
            err = float((g - w_).abs().max())
            red_err = max(red_err, err)
            rel = err / float(w_.abs().max())
            print(f"reduce_partials: [{pw.shape[0]}, {pw.shape[1]}] and "
                  f"[{pb.shape[0]}, {pb.shape[1]}]; max abs err {err:.3e}, "
                  f"over the max {rel:.3e}")
            if not rel <= TOL_SEGSUM:
                raise AssertionError(f"reduce_partials: err {rel} > "
                                     f"{TOL_SEGSUM}")
            if not torch.equal(g, a):
                raise AssertionError("reduce_partials: two launches differ")

    # --- 12. the fused slice at full width -----------------------------------
    mlp_calls = [0]
    mlp_forward = GeneralMLP.forward

    def counting_forward(self, *args, **kwargs):
        mlp_calls[0] += 1
        return mlp_forward(self, *args, **kwargs)

    sp, st = sc.params, sc.stats
    sopt, fp, fopt = splats.adam_init(sp), sc.deform.params, sc.deform.opt_state
    fp0 = {k: v.clone() for k, v in fp.items()}
    losses = []
    GeneralMLP.forward = counting_forward
    try:
        torch.cuda.synchronize()
        blend_fwd.launches = blend_bwd.launches = 0
        fm.fused_heads.launches = fm.fused_heads_bwd.launches = 0
        fm.fused_dw.launches = fm.reduce_partials.launches = 0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for i, b in enumerate(batches[:TRAIN_WARMUP + TRAIN_STEPS]):
            if i == TRAIN_WARMUP:
                start.record()
            sp, st, sopt, fp, fopt, out = step(sp, st, sopt, fp, fopt, b, lrs,
                                               FIELD_LR)
            losses.append(out.loss)
        end.record()
        torch.cuda.synchronize()
        steps = TRAIN_WARMUP + TRAIN_STEPS
        launches = (fm.fused_heads.launches, fm.fused_heads_bwd.launches,
                    fm.fused_dw.launches, fm.reduce_partials.launches,
                    blend_fwd.launches, blend_bwd.launches)
        step_calls = mlp_calls[0]
        # serving frames through the fused forward
        fm.fused_heads.launches = 0
        frames = list(render_cameras_batched(sc.cams, sc.params, sc.stats,
                                             sc.deform, sc.pipe, sc.bg))
        torch.cuda.synchronize()
        frame_launches, frame_calls = fm.fused_heads.launches, mlp_calls[0]
    finally:
        GeneralMLP.forward = mlp_forward
    if launches != (2 * steps,) * 4 + (steps,) * 2:
        raise AssertionError(f"{steps} fused steps launched the fused "
                             "forward, backward, dW, reduction, blend_fwd "
                             f"and blend_bwd {launches} times")
    if step_calls or frame_calls:
        raise AssertionError(f"GeneralMLP.forward ran {frame_calls} times on "
                             "the fused path")
    if frame_launches != 2 * N_FRAMES:
        raise AssertionError(f"{N_FRAMES} fused frames launched the forward "
                             f"{frame_launches} times")
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite fused loss: {losses.tolist()}")
    moved = {k: float((fp[k] - fp0[k]).abs().max()) for k in fp}
    if not all(moved[k] > 0 for k in moved if k.startswith("mlp_")):
        raise AssertionError("a head parameter did not move")
    for i, f in enumerate(frames):
        if not bool(torch.isfinite(f["render"]).all()):
            raise AssertionError(f"fused frame {i}: non-finite render")
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    print("fused training losses:", [round(x, 6) for x in losses.tolist()])
    print(f"fused: field moved by up to {max(moved.values()):.3e}")
    print(f"fused train ms/step {step_ms:.4f}; rays/s "
          f"{RES * RES / step_ms * 1e3:.1f} ({RES}x{RES}, {N_SPLATS} splats, "
          f"1 view, bf16 heads, {TRAIN_STEPS} steps after {TRAIN_WARMUP} "
          f"warm-up; fused forward, backward, dW, reduction, blend_fwd, "
          f"blend_bwd launches {launches} for {steps} steps; "
          f"GeneralMLP.forward calls {step_calls}; {smi})")

    def render_all():
        for cam in sc.cams:
            render_camera(cam, sc.params, sc.stats, sc.deform, sc.pipe, sc.bg)

    frame_ms = cuda_ms(render_all, 3) / N_FRAMES
    print(f"fused render ms/frame {frame_ms:.4f} ({N_FRAMES} frames, fused "
          f"forward launches {frame_launches}, GeneralMLP.forward calls "
          f"{frame_calls})")

    # each kernel at the step's shapes (both plans: one step's launches)
    def per_plan(fn):
        return lambda: [fn(plan, emb, feat, w, b, gs)
                        for plan, emb, feat, w, b, gs in cases]

    with torch.no_grad():
        fwd_ms = cuda_ms(per_plan(lambda *a: fm.fused_heads(*a[:5], bf16)), 10)
        fwd_plain_ms = cuda_ms(per_plan(
            lambda *a: fm.fused_heads_plain(*a[:5], bf16)), 3)
    # the three kernels of the backward: each alone on the step's inputs,
    # scratch and partials, and all three as the autograd backward runs them
    bwd_ms = cuda_ms(per_plan(lambda *a: fm.launch_bwd(*a, bf16)), 5)
    bwd_plain_ms = cuda_ms(per_plan(
        lambda *a: fm.fused_heads_bwd_plain(*a, bf16)), 3)
    bwd_total_ms = cuda_ms(per_plan(
        lambda *a: fm.fused_heads_bwd(*a, bf16)), 5)
    plans = [c[0] for c in cases]

    def dw_all():
        return [fm.fused_dw(p, s, n) for p, s in zip(plans, scratches)]

    def dw_plain_all():
        return [fm.fused_dw_plain(p, s, n, parts.shape[0])
                for p, s, parts in zip(plans, scratches, dw_parts)]

    blocks = [xg for p, s in zip(plans, scratches)
              for xg in fm.scratch_blocks(p, s, n)]

    def dw_library():
        # no single call computes every layer's product: one cuBLAS bf16
        # torch.mm per layer on the same scratch
        return [torch.mm(x.t(), g) for x, g in blocks]

    dw_ms = cuda_ms(dw_all, 20)
    dw_plain_ms = cuda_ms(dw_plain_all, 3)
    dw_lib_ms = cuda_ms(dw_library, 20)
    # the reduction's ~10 us of work a step is below the host's launch
    # time: its eager time (the kernels line's method) is the wrapper's;
    # the device time from a CUDA graph's replay is printed beside it
    def red_all():
        return [fm.reduce_partials(pw, pb) for pw, pb in zip(dw_parts, b_parts)]

    def red_lib():
        return [(pw.sum(0), pb.sum(0)) for pw, pb in zip(dw_parts, b_parts)]

    red_ms, red_lib_ms = cuda_ms(red_all, 20), cuda_ms(red_lib, 20)
    red_graph_ms, red_lib_graph_ms = (graph_ms(red_all, 20),
                                      graph_ms(red_lib, 20))
    flops = heads_flops(plans, n)
    in_bytes = sum((emb.numel() + feat.numel() + w.numel() + b.numel()) * 4
                   for _, emb, feat, w, b, _ in cases)
    out_bytes = sum(g.numel() * 4 for c in cases for g in c[5])
    scratch_bytes = sum(s.numel() * s.element_size() for s in scratches)
    dw_part_bytes = sum(p.numel() * 4 for p in dw_parts)
    b_part_bytes = sum(p.numel() * 4 for p in b_parts)
    grad_bytes = sum((emb.numel() + feat.numel()) * 4
                     for _, emb, feat, *_ in cases)
    fwd_bytes = in_bytes + out_bytes
    # the backward kernel's own work, recompute, dX and db: it reads the
    # inputs and cotangents and writes d_emb, d_feat and db. The scratch
    # it also writes is a cost of the split (bound "scratch" below), not of
    # that work
    bwd_bytes = in_bytes + out_bytes + grad_bytes + sum(
        b.numel() * 4 for _, _, _, _, b, _ in cases)
    # the dW GEMM reads the scratch once and writes its slice partials
    dw_bytes = scratch_bytes + dw_part_bytes
    red_bytes = dw_part_bytes + b_part_bytes + sum(
        (p.shape[1] + q.shape[1]) * 4 for p, q in zip(dw_parts, b_parts))
    # the whole VJP, as one function: inputs and cotangents in, d_emb,
    # d_feat, dW and db out
    vjp_bytes = in_bytes + out_bytes + grad_bytes + sum(
        (w.numel() + b.numel()) * 4 for _, _, _, w, b, _ in cases)
    bounds = {}
    for name, ops, nbytes, rate in (
            ("fwd", flops, fwd_bytes, BF16_FLOPS),
            ("bwd", 2 * flops, bwd_bytes, BF16_FLOPS),
            ("scratch", 0, scratch_bytes, BF16_FLOPS),
            ("dw", flops, dw_bytes, BF16_FLOPS),
            ("reduce", (dw_part_bytes + b_part_bytes) // 4, red_bytes,
             F32_FLOPS),
            ("vjp", 3 * flops, vjp_bytes, BF16_FLOPS)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / rate * 1e3
        bounds[name] = (max(bytes_ms, ops_ms),
                        "bytes" if bytes_ms > ops_ms else "operations")
        print(f"fused {name}: {ops} operations, {nbytes} bytes; bytes bound "
              f"{bytes_ms:.5f} ms, ops bound {ops_ms:.5f} ms "
              f"({'bf16 tensor-core' if rate == BF16_FLOPS else 'f32'} rate; "
              f"f32 rate {ops / F32_FLOPS * 1e3:.5f} ms)")
    print(f"fused_heads forward (2 plans, bf16): kernel {fwd_ms:.5f} ms, "
          f"plain {fwd_plain_ms:.5f} ms; {flops} forward FLOP on {n} points")
    print(f"fused_heads backward (2 plans, bf16): backward kernel "
          f"{bwd_ms:.5f} ms, fused_mlp_dw {dw_ms:.5f} ms (plain "
          f"{dw_plain_ms:.5f}, per-layer torch.mm {dw_lib_ms:.5f}; slices "
          f"{[p.shape[0] for p in dw_parts]}), reduce_partials {red_ms:.5f} "
          f"ms (sum(0) {red_lib_ms:.5f}; from a CUDA graph's replay "
          f"{red_graph_ms:.5f} and {red_lib_graph_ms:.5f}); sum of the "
          f"three {bwd_ms + dw_ms + red_ms:.5f} ms, fused_heads_bwd "
          f"{bwd_total_ms:.5f} ms, plain {bwd_plain_ms:.5f} ms; scratch "
          f"{scratch_bytes} bytes")

    # the heads alone from (xyz, features): fused (bf16 kernels) against
    # the port's GeneralMLP chain (f32 F.linear), forward and fwd + bwd
    with torch.no_grad():
        xyz = sc.params.xyz.detach()
        feat = net.extract_features(xyz)
    keys = ("means3D", "scales", "opacity", "rotations", "rgb")
    head_params = [p for k, p in net.named_parameters() if k.startswith("mlp_")]

    def heads(call, backward):
        def run():
            with torch.set_grad_enabled(backward):
                o = call(xyz, feat)
                if backward:
                    loss = sum(o[k].sum() for k in keys)
                    torch.autograd.grad(loss, head_params)
        return run

    head_ms = {}
    for name, call in (("fused", net._call_fused),
                       ("unfused", net._call_unfused)):
        for backward in (False, True):
            head_ms[(name, backward)] = cuda_ms(heads(call, backward), 5)
    print(f"heads alone, {n} points: fused forward "
          f"{head_ms[('fused', False)]:.5f} ms, fused forward + backward "
          f"{head_ms[('fused', True)]:.5f} ms; unfused (GeneralMLP, f32) "
          f"forward {head_ms[('unfused', False)]:.5f} ms, forward + backward "
          f"{head_ms[('unfused', True)]:.5f} ms")
    net.fused_pallas = "auto"

    # --- 13. small fused step: kernels on the card vs plain on the CPU ------
    cam = make_views(2, 64)[1]
    res = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        p_, s_ = splats.create_from_pcd(sc.pts[:2000], sc.cols[:2000], 0,
                                        device=device)
        d_ = DeformModel(sc.hidden, radius=1.0, seed=0, device=device)
        # f32 on both sides: one rounding type, so the two agree as in
        # phase 7 (bf16 is phase 11's and 12's)
        d_.net.fused_pallas, d_.net.fused_compute_dtype = "on", torch.float32
        before = (fm.fused_heads.launches, fm.fused_heads_bwd.launches,
                  fm.fused_dw.launches)
        res[name] = train_step_fn(d_, sc.pipe, 64)(
            p_, s_, nonzero_adam(p_, 1), d_.params, nonzero_adam(d_.params, 2),
            train_batch(cam, np.random.RandomState(1), device), lrs,
            FIELD_LR)
        ran = (fm.fused_heads.launches - before[0],
               fm.fused_heads_bwd.launches - before[1],
               fm.fused_dw.launches - before[2])
        if ran != ((2, 2, 2) if name == "cuda" else (0, 0, 0)):
            raise AssertionError(f"small fused step on {name}: launches {ran}")
    check_small_step(res["cuda"], res["cpu"])

    common = {"route": "cuda", "library_ms": None}
    return [{
        **common,
        "name": "fused_heads_fwd",
        "source": "splatfields_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "splatfields_tpu/ops/fused_mlp.py:308",
        "launches": launches[0],
        "max_abs_err": fwd_err,
        "ms": fwd_ms,
        "kernel_ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
        "bound_ms": bounds["fwd"][0],
        "bound_by": bounds["fwd"][1],
        # no single PyTorch call computes these heads; the GeneralMLP chain
        "unfused_heads_fwd_ms": head_ms[("unfused", False)],
    }, {
        **common,
        "name": "fused_heads_bwd",
        "source": "splatfields_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "splatfields_tpu/ops/fused_mlp.py:338",
        "launches": launches[1],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "kernel_ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["bwd"][0],
        "bound_by": bounds["bwd"][1],
        # the backward's three kernels in turn, as autograd runs them, the
        # bound of the whole VJP and the bytes bound of the scratch writes
        "fused_heads_bwd_total_ms": bwd_total_ms,
        "vjp_bound_ms": bounds["vjp"][0],
        "scratch_write_bound_ms": bounds["scratch"][0],
        "unfused_heads_fwd_bwd_ms": head_ms[("unfused", True)],
    }, {
        "name": "fused_heads_dw",
        "route": "cuda",
        "source": "splatfields_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "splatfields_tpu/ops/fused_mlp.py:338",
        "launches": launches[2],
        "max_abs_err": dw_err,
        "ms": dw_ms,
        "kernel_ms": dw_ms,
        "plain_ms": dw_plain_ms,
        "bound_ms": bounds["dw"][0],
        "bound_by": bounds["dw"][1],
        # no single call: one cuBLAS bf16 torch.mm per layer
        "library_ms": dw_lib_ms,
    }, {
        "name": "reduce_partials",
        "route": "cuda",
        "source": "splatfields_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "splatfields_tpu/ops/fused_mlp.py:338",
        "launches": launches[3],
        "max_abs_err": red_err,
        "ms": red_ms,
        "kernel_ms": red_ms,
        # the plain version is the library call, parts.sum(0) on both
        "plain_ms": red_lib_ms,
        "bound_ms": bounds["reduce"][0],
        "bound_by": bounds["reduce"][1],
        "library_ms": red_lib_ms,
    }]


class LoopBlends:
    """Inside ``with``: the blend kernels' arguments as a training run
    hands them over, detached: the last step's forward (``step_fwd``) and
    backward (``step_bwd``) and the last evaluation frame's forward
    (``eval_fwd``, rendered without grad). The launch counts stay the
    wrappers'."""

    def __enter__(self):
        import torch

        from splatfields_torch.ops.raster import api, blend_cuda
        self.fwd, self.bwd = api.blend_fwd, blend_cuda.blend_bwd
        self.step_fwd = self.eval_fwd = self.step_bwd = None

        def detached(args):
            return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                         for a in args)

        def fwd_spy(*args):
            if torch.is_grad_enabled():
                self.step_fwd = detached(args)
            else:
                self.eval_fwd = detached(args)
            return self.fwd(*args)

        def bwd_spy(*args):
            self.step_bwd = detached(args)
            return self.bwd(*args)

        # the backward wrapper counts through its module-level name
        bwd_spy.launches = self.bwd.launches
        api.blend_fwd, blend_cuda.blend_bwd = fwd_spy, bwd_spy
        return self

    def __exit__(self, *exc):
        from splatfields_torch.ops.raster import api, blend_cuda
        self.bwd.launches = blend_cuda.blend_bwd.launches
        api.blend_fwd, blend_cuda.blend_bwd = self.fwd, self.bwd


def check_loop_blends(label, cap):
    """Both kernels against their plain versions on ``cap``'s captured
    arguments (a ``LoopBlends``; its evaluation frame when the loop
    evaluated), the backward twice bitwise equal -> {which: max abs
    err}."""
    import torch

    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.raster.blend_torch import (
        blend_bwd_plain,
        blend_sorted_plain,
    )
    errs = {}
    for which, args in (("step", cap.step_fwd),
                        ("evaluation frame", cap.eval_fwd)):
        if args is None:    # a loop without an evaluation
            continue
        pack, _, counts = args[:3]
        print(f"{label}, {which}: sorted_pack {tuple(pack.shape)}, "
              f"{int(counts.sum())} instances, max tile count "
              f"{int(counts.max())}")
        errs[which] = max(check_close(f"{label}, {which} forward",
                                      blend_fwd(*args),
                                      blend_sorted_plain(*args)).values())
    k_chunk = cap.step_fwd[7]
    got = blend_bwd(*cap.step_bwd)
    torch.cuda.synchronize()
    errs["step backward"] = check_bwd(f"{label}, step backward", got,
                                      blend_bwd_plain(*cap.step_bwd, k_chunk))
    if not float(got.abs().max()) > 0:
        raise AssertionError(f"{label}: the step's backward is all zero")
    if not torch.equal(blend_bwd(*cap.step_bwd), got):
        raise AssertionError(f"{label}: two blend_bwd launches differ")
    return errs


def check_partial_tiles(label, cap, width, height):
    """A frame whose size is not a multiple of the tile (``cap`` a
    ``LoopBlends`` of it): the tiles partly off the image hold rows, both
    kernels agree with their plain versions on those tiles (TOL; TOL_BWD of
    each column's max over the tiles' rows), and the upstream gradient
    the backward reads is 0 on every off-image pixel -> {which: err}."""
    import torch

    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.raster.blend_torch import (
        blend_bwd_plain,
        blend_sorted_plain,
    )
    pack, tile_start, counts, tiles_x, tiles_y, tile_size, tile_cap, \
        k_chunk = cap.step_fwd[:8]
    # [T, P]: the pixels of each tile that lie off the image
    pix = torch.arange(tile_size * tile_size, device=pack.device)
    t = torch.arange(tiles_x * tiles_y, device=pack.device)
    off = (((t // tiles_x)[:, None] * tile_size + (pix // tile_size)[None]
            >= height)
           | ((t % tiles_x)[:, None] * tile_size + (pix % tile_size)[None]
              >= width))
    partial = off.any(dim=1)
    n_rows = int(counts[partial].clamp(max=tile_cap).sum())
    if not (bool(partial.any()) and n_rows > 0):
        raise AssertionError(f"{label}: no rows in a partial tile")
    got, want = blend_fwd(*cap.step_fwd), blend_sorted_plain(*cap.step_fwd)
    errs = {k: float((g[partial] - w[partial]).abs().max())
            for k, g, w in zip(TOL, got, want)}
    for k, e in errs.items():
        if not e <= TOL[k]:
            raise AssertionError(f"{label}: partial tiles' {k} err {e}")
    g_color, g_depth, g_tfinal = cap.step_bwd[4:7]
    leak = max(float(g_color.abs().amax(dim=1)[off].max()),
               float(g_depth.abs()[off].max()),
               float(g_tfinal.abs()[off].max()))
    reach = float(g_color.abs().amax(dim=1)[partial][~off[partial]].max())
    if not (leak == 0.0 and reach > 0):
        raise AssertionError(f"{label}: upstream gradient {leak} off the "
                             f"image, {reach} on it")
    rows = torch.cat([torch.arange(int(tile_start[t]), int(tile_start[t])
                                   + min(int(counts[t]), tile_cap),
                                   device=pack.device)
                      for t in torch.nonzero(partial).flatten().tolist()])
    bwd_got = blend_bwd(*cap.step_bwd)[rows]
    bwd_want = blend_bwd_plain(*cap.step_bwd, k_chunk)[rows]
    col, _ = column_errs(bwd_got, bwd_want)
    errs["backward"] = float(col.max())
    if not errs["backward"] <= TOL_BWD:
        raise AssertionError(f"{label}: partial tiles' backward {col}")
    print(f"{label}: {int(partial.sum())} partial tiles, {n_rows} rows, "
          f"{int(off.sum())} off-image pixels with upstream gradient "
          f"{leak}; errors {errs}")
    return errs


def read_metrics(model_path):
    """metrics.jsonl's scalar records -> {tag: [(step, value), ...]}."""
    out = {}
    with open(os.path.join(model_path, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "histogram" in rec:
                continue
            for k, v in rec.items():
                if k != "step":
                    out.setdefault(k, []).append((rec["step"], v))
    return out


def on_card(label, tensors):
    for k, t in tensors.items():
        if t.device.type != "cuda":
            raise AssertionError(f"{label}: {k} is on {t.device}")


def png_round_trip_bound(render_dir):
    """Largest |PSNR(render) - PSNR(its uint8 PNG)| a frame can have: the
    PNG truncates each value by e in [0, 1/255), so the root mean squared
    error moves by at most 1/255 (triangle inequality) and
    |dPSNR| <= 20 log10(rmse_png / (rmse_png - 1/255)), largest over the
    frames (and so over their mean)."""
    import glob

    from splatfields_torch.data import png
    worst = 0.0
    for gt_path in sorted(glob.glob(os.path.join(render_dir, "gt", "*.png"))):
        gt = png.read(gt_path)[..., :3].astype(np.float64) / 255
        r = png.read(gt_path.replace(os.sep + "gt" + os.sep,
                                     os.sep + "renders" + os.sep))
        rmse = float(np.sqrt(np.mean((r[..., :3] / 255 - gt) ** 2)))
        if not rmse > 1 / 255:
            raise AssertionError(f"{gt_path}: rmse {rmse} too small to bound")
        worst = max(worst, 20 * math.log10(rmse / (rmse - 1 / 255)))
    return worst


PROTOCOL_TEST_THETAS = (0.3, 1.9, 3.5, 5.1)
PROTOCOL_GT_SPLATS = 30_000
PROTOCOL_3DGS = ("--white_background --eval --is_static --n_views 10 "
                 "--pts_samples hull --max_num_pts 300000 --load_time_step 0 "
                 "--composition_rank 0").split()
# phase 16's iterations, and 10 more resumed
PROTOCOL_FIELD_ITERS = 30
PROTOCOL_FIELD = ("--white_background --eval --encoder_type "
                  "VarTriPlaneEncoder --lambda_norm 0.01 --n_views 10 "
                  "--pts_samples load --max_num_pts 100000 --load_time_step 0 "
                  "--composition_rank 0").split()


def protocol_phases(dev, smi):
    """Phases 14-17: the Blender protocol through the port's CLIs.
    Returns ({kernel name: {phase: launches}}, {phase: check_loop_blends'
    errors})."""
    import argparse
    import shutil
    import time

    import torch

    from splatfields_torch import render, train
    from splatfields_torch.config import PipelineConfig
    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.point_init import visual_hull_from_grid
    from splatfields_torch.data.readers import blender
    from splatfields_torch.metrics import eval_imgs, read_results
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.render_lib import render_camera

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "blender_protocol")
    shutil.rmtree(base, ignore_errors=True)
    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs = {}

    # --- 14. the scene ----------------------------------------------------
    t0 = time.time()
    root = write_blender_scene(base, RES, 100, PROTOCOL_TEST_THETAS, dev,
                               n_splats=PROTOCOL_GT_SPLATS)
    torch.cuda.synchronize()
    print(f"phase 14: {RES}x{RES} Blender_cv scene, 100 train + "
          f"{len(PROTOCOL_TEST_THETAS)} test views, {PROTOCOL_GT_SPLATS} "
          f"ground-truth splats, written in {time.time() - t0:.2f} s")
    t0 = time.time()
    infos, pos = blender.read_cameras_from_transforms_cv(
        root, "transforms_train.json", True)
    read_s = time.time() - t0
    picked = [infos[i] for i in sorted(blender.kmeans_downsample(pos, 10))]
    t0 = time.time()
    hull = visual_hull_from_grid(picked, (-1.0, 1.0), 256, 100_000,
                                 rng=np.random.RandomState(0))
    carve_s = time.time() - t0
    frame = png.read(os.path.join(root, "train", "r_0.png"))
    paeth = png.encode(frame, 4)
    t0 = time.time()
    again = png.decode(paeth)
    paeth_s = time.time() - t0
    if not np.array_equal(again, frame):
        raise AssertionError("Paeth round trip of a frame differs")
    mask_share = float((frame[..., 3] > 0).mean())
    print(f"host: reader {read_s:.3f} s for 100 {RES}x{RES} RGBA frames "
          f"({read_s * 10:.2f} ms/frame, filter 0), one frame with Paeth "
          f"rows decoded in {paeth_s * 1000:.1f} ms; 256^3 hull carve over "
          f"10 views {carve_s:.3f} s -> {hull.shape[0]} points (mask covers "
          f"{mask_share:.3f} of a frame); {smi}")

    # --- 15. the 3DGS baseline --------------------------------------------
    out_3dgs = os.path.join(base, "out", "3DGS")
    argv = (["-s", root, "-m", out_3dgs] + PROTOCOL_3DGS
            + ["--iterations", "300", "--densify_from_iter", "100",
               "--densification_interval", "100",
               "--test_iterations", "1", "300"])
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with LoopBlends() as cap:
        res = train.main(argv)
    torch.cuda.synchronize()
    params, stats, deform = res.params, res.stats, res.deform
    trained_3dgs = (params, stats)
    launches["blend_fwd"]["15"] = blend_fwd.launches
    launches["blend_bwd"]["15"] = blend_bwd.launches
    evals = 2 * (len(PROTOCOL_TEST_THETAS) + 5)
    if (blend_fwd.launches, blend_bwd.launches) != (300 + evals, 300):
        raise AssertionError(
            f"phase 15: blend launches {blend_fwd.launches}, "
            f"{blend_bwd.launches}; want {300 + evals}, 300")
    if deform is not None:
        raise AssertionError("phase 15: a static run built a field")
    on_card("phase 15", {**dict(vars(params)), **dict(vars(stats))})
    if [d[0] for d in res.densified] != [200, 300]:
        raise AssertionError(f"phase 15: densified {res.densified}; want at "
                             "200 and 300")
    m = read_metrics(out_3dgs)
    psnr = dict(m["test/loss_viewpoint - psnr"])
    if not psnr[300] > psnr[1]:
        raise AssertionError(f"phase 15: test PSNR {psnr[1]} -> {psnr[300]}")
    for rel in ("point_cloud/iteration_300/point_cloud.ply",
                "train_state/iteration_300/state.pt", "cfg_args",
                "cameras.json", "input.ply"):
        if not os.path.exists(os.path.join(out_3dgs, rel)):
            raise AssertionError(f"phase 15: {rel} not written")
    if os.path.exists(os.path.join(out_3dgs, "deform")):
        raise AssertionError("phase 15: a static run wrote field weights")
    dropped = [int(v) for _, v in m.get("train_loss_patches/bin_dropped", [])]
    print(f"phase 15: 3DGS baseline 300 iterations, {res.ms_per_it:.3f} ms/it "
          f"({RES}x{RES}, {int(stats.valid.sum())} splats at the end); test "
          f"PSNR {psnr[1]:.3f} at 1 -> {psnr[300]:.3f} at 300; densify "
          f"(iteration, before, after, dropped) {res.densified}; instances "
          f"dropped past dup_cap a step (every 10th): max "
          f"{max(dropped, default=0)}, mean "
          f"{np.mean(dropped) if dropped else 0:.1f}, dup_factor growth "
          f"(iteration, dropped, new factor) {res.dup_growth}; blend launches "
          f"{launches['blend_fwd']['15']} fwd, "
          f"{launches['blend_bwd']['15']} bwd; {smi}")
    # the kernels on the trained scene's own inputs at the grown dup_factor
    loop_errs["15"] = check_loop_blends("phase 15", cap)
    del cap

    # --- 16. SplatFields3D --------------------------------------------------
    out_field = os.path.join(base, "out", "SplatFields")
    it = PROTOCOL_FIELD_ITERS
    pc = os.path.join(out_3dgs, "point_cloud", "iteration_300",
                      "point_cloud.ply")
    argv = (["-s", root, "-m", out_field] + PROTOCOL_FIELD
            + ["--pc_path", pc, "--test_iterations", "1", str(it)])
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with LoopBlends() as cap:
        res = train.main(argv + ["--iterations", str(it)])
    torch.cuda.synchronize()
    params, stats, deform = res.params, res.stats, res.deform
    launches["blend_fwd"]["16"] = blend_fwd.launches
    launches["blend_bwd"]["16"] = blend_bwd.launches
    if (blend_fwd.launches, blend_bwd.launches) != (it + evals, it):
        raise AssertionError(
            f"phase 16: blend launches {blend_fwd.launches}, "
            f"{blend_bwd.launches}; want {it + evals}, {it}")
    on_card("phase 16", {**dict(vars(params)), **dict(vars(stats)),
                         **deform.params})
    ms_it, growth_16 = res.ms_per_it, res.dup_growth
    loop_errs["16"] = check_loop_blends("phase 16", cap)
    del cap
    m = read_metrics(out_field)
    eval_psnr = dict(m["test/loss_viewpoint - psnr"])[it]
    # the trained scenes at the default budget (dup_factor 5): instances
    # dropped past dup_cap on each test view
    test_cams = [load_cam(info, -1, i, device=dev) for i, info in enumerate(
        blender.read_cameras_from_transforms_cv(
            root, "transforms_test.json", True)[0])]
    white = np.ones(3, np.float32)
    at_default = {name: [render_camera(
        c, *state, PipelineConfig(), white, field_mode=fm)
        for c in test_cams] for name, state, fm in (
            ("3DGS at 300", (*trained_3dgs, None), False),
            ("SplatFields3D at the end", (params, stats, deform), True))}
    # the loop's own frames of the run at 200 as render.py quantizes them
    own_pngs = [render._to_png(out["render"])
                for out in at_default["SplatFields3D at the end"]]
    at_default = {k: [int(out["n_dropped"]) for out in v]
                  for k, v in at_default.items()}
    trained = {k: v.detach().cpu().clone()
               for k, v in deform.net.state_dict().items()}
    resumed = train.main(argv + ["--iterations", str(it + 10), "--resume"])
    if resumed.start_iteration != it + 1:
        raise AssertionError(f"phase 16: --resume started at "
                             f"{resumed.start_iteration}, not {it + 1}")
    steps = [s for s, _ in read_metrics(out_field)[
        "train_loss_patches/total_loss"]]
    if steps[-2:] != [it, it + 10] or steps.count(it) != 1:
        raise AssertionError(f"phase 16: resumed steps {steps[-4:]}")
    t0 = time.time()
    render.main(["-s", root, "-m", out_field, "--skip_train",
                 "--iteration", str(it)])
    torch.cuda.synchronize()
    render_s = time.time() - t0
    n_frames = len(PROTOCOL_TEST_THETAS)
    ours = os.path.join(out_field, "test", f"ours_{it}")
    yaml = read_results(os.path.join(ours, "results.yaml"))
    bound = png_round_trip_bound(ours)
    if not abs(yaml["psnr"] - eval_psnr) <= bound:
        raise AssertionError(
            f"phase 16: render.py PSNR {yaml['psnr']} vs evaluate "
            f"{eval_psnr}: beyond the PNG bound {bound}")
    # render.py's frames (the run reloaded from its PLY and deform.msgpack)
    # against the loop's own state: each value within one level, and the
    # PSNR of the loop's frames against the same gt PNGs within 1e-3 dB
    level_diff, off, own_psnr = 0, 0, []
    for i, mine in enumerate(own_pngs):
        theirs = png.read(os.path.join(ours, "renders", f"{i:05d}.png"))
        d = np.abs(mine.astype(np.int16) - theirs[..., :3])
        level_diff, off = max(level_diff, int(d.max())), off + int(
            (d > 0).sum())
        gt = png.read(os.path.join(ours, "gt", f"{i:05d}.png"))[..., :3]
        own_psnr.append(eval_imgs(mine, gt)["psnr"])
    psnr_gap = abs(float(np.mean(own_psnr)) - yaml["psnr"])
    if not (level_diff <= 1 and psnr_gap <= 1e-3):
        raise AssertionError(
            f"phase 16: render.py's frames differ from the loop's by up to "
            f"{level_diff} levels ({off} values), PSNR by {psnr_gap} dB")
    hidden = train.cfg_lib.extract_configs(argparse.Namespace(
        **train.cfg_lib.load_cfg_args(out_field)))[2]
    check = DeformModel(hidden, radius=1.0, seed=7, device=dev)
    check.load_weights(out_field, it)
    for k, v in check.net.state_dict().items():
        if not torch.equal(v.cpu(), trained[k]):
            raise AssertionError(f"phase 16: deform.msgpack {k} differs")
    print(f"phase 16: SplatFields3D {it} iterations, {ms_it:.3f} ms/it; "
          f"resumed to {it + 10}; render CLI {n_frames} test frames in "
          f"{render_s:.3f} s ({render_s * 1000 / n_frames:.1f} ms/frame, "
          f"scene load, PNG writes and metrics included); results.yaml PSNR "
          f"{yaml['psnr']:.4f}, SSIM {yaml['ssim']:.4f}, evaluate PSNR "
          f"{eval_psnr:.4f} (|diff| {abs(yaml['psnr'] - eval_psnr):.4f} <= "
          f"PNG bound {bound:.4f}); render.py's frames against the loop's: "
          f"up to {level_diff} level(s) apart in {off} values, PSNR "
          f"|diff| {psnr_gap:.2e} dB; dup_factor growth {growth_16}; instances "
          f"dropped past dup_cap at dup_factor 5 on the test views "
          f"{at_default}; blend launches "
          f"{launches['blend_fwd']['16']} fwd, "
          f"{launches['blend_bwd']['16']} bwd; {smi}")
    del resumed, trained_3dgs
    deform = None

    # --- 17. card against CPU -----------------------------------------------
    small = write_blender_scene(os.path.join(base, "small"), 64, 5,
                                (0.3, 2.5), torch.device("cpu"))
    for mode, flags in (("3DGS", ["--is_static", "--pts_samples", "hull"]),
                        ("SplatFields", ["--encoder_type",
                                         "VarTriPlaneEncoder",
                                         "--lambda_norm", "0.01",
                                         "--pts_samples", "random"])):
        card_vs_cpu(f"phase 17 {mode}",
                    ["-s", small, "--white_background", "--eval",
                     "--n_views", "4", "--num_pts", "2000",
                     "--load_time_step", "0", "--composition_rank", "0"]
                    + flags, os.path.join(base, "small_out", mode), dev)
    return launches, loop_errs


PROTOCOL_MORAN = ("--white_background --eval --is_static --n_views 10 "
                  "--pts_samples hull --max_num_pts 300000 --lambda_corr 0.01 "
                  "--load_time_step 0 --composition_rank 0").split()
MORAN_ITERS = 20
# run_dtu.sh's flags (its 3DGS lines keep --load_time_step at its default)
DTU_3DGS = ("--white_background --lambda_mask 0.1 -r 2 --is_static "
            "--n_views 3").split()
DTU_FIELD = ("--deform_weight 0 --white_background --lambda_mask 0.1 "
             "--n_views 3 --lambda_norm 0.01 --encoder_type "
             "VarTriPlaneEncoder --W 128 --max_num_pts 300000 -r 2 "
             "--load_time_step 0 --composition_rank 0").split()
DTU_SIZE, DTU_VIEWS = (1600, 1200), 4
DTU_ITERS, DTU_FIELD_ITERS = 50, 10
MESH_RES, MESH_THRESHOLD = 64, 0.5


class CorrTimer:
    """Inside ``with``: CUDA events around each ``train_lib.corr_term``
    call (the Moran terms' forward: parking, KNN, weights, the sums), and
    the valid mask it saw."""

    def __enter__(self):
        from splatfields_torch import train_lib
        self.orig, self.calls = train_lib.corr_term, []

        def timed(attrs, valid, opt):
            import torch
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.orig(attrs, valid, opt)
            ev[1].record()
            self.calls.append((ev, valid))
            return out

        train_lib.corr_term = timed
        return self

    def __exit__(self, *exc):
        from splatfields_torch import train_lib
        train_lib.corr_term = self.orig

    def summary(self):
        """([ms of each call], [(capacity, valid splats) of each call])."""
        import torch
        torch.cuda.synchronize()
        return ([a.elapsed_time(b) for (a, b), _ in self.calls],
                [(int(v.shape[0]), int(v.sum())) for _, v in self.calls])


def write_lpips_weights(path, seed=0):
    """A seeded random VGG16-LPIPS weight file in ``ops/lpips.py``'s
    layout (He-scaled convs, positive ``lins``) -> its path."""
    chans = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    convs = [i for blk in ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21),
                           (24, 26, 28)) for i in blk]
    rng = np.random.RandomState(seed)
    w = {}
    for n, i in enumerate(convs):
        cin, cout = chans[n], chans[n + 1]
        w[f"features.{i}.weight"] = (rng.randn(cout, cin, 3, 3) * np.sqrt(
            2.0 / (9 * cin))).astype(np.float32)
        w[f"features.{i}.bias"] = (rng.randn(cout) * 0.01).astype(np.float32)
    for k, c in enumerate((64, 128, 256, 512, 512)):
        w[f"lins.{k}.weight"] = rng.rand(1, c, 1, 1).astype(np.float32)
    np.savez(path, **w)
    return str(path)


def mesh_counts(path):
    """(vertices, faces) of a mesh PLY's header."""
    with open(path, "rb") as f:
        head = f.read(400).split(b"end_header")[0].decode()
    return (int(head.split("element vertex ")[1].split()[0]),
            int(head.split("element face ")[1].split()[0]))


# Phase 19's SplatFields3D check. The card's and the CPU's field outputs
# of one saved state differ by f32 summation order (up to ~1e-6 of the
# largest value on an H100), and that moves near-tie neighbourhoods of
# the KNN (tens to hundreds of 93,111 rows), so Moran's I card against
# CPU is ill-conditioned across the two sides' inputs. The check holds
# instead: the field outputs within TOL_FIELD (a known fault, the card's
# field in bf16 against the CPU's f32, reads ~1e-2); Moran's I on the CPU
# over the card's own neighbourhoods and inputs (the weights recomputed on
# the CPU from the card's positions) within TOL_MORAN of the card's
# report; and every neighbourhood that differs between the two sides a
# near tie (``neighbour_flips``).
TOL_FIELD = 1e-5
TOL_MORAN = 1e-5   # |diff| / (|CPU| + 0.1), as 3DGS's check


def neighbour_flips(pts_a, nn_a, pts_b, nn_b):
    """The rows whose neighbour sets differ between two KNN runs (``nn_a``
    on ``pts_a``, ``nn_b`` on ``pts_b``, [N, K] indices), and which of them
    are not near ties. A row is a near tie when each neighbour that one
    side holds and the other does not lies, by the other side's squared
    distances (float64), within ``slack`` of that side's farthest
    neighbour. ``slack`` is what the positions' largest gap ``d`` (the
    Euclidean norm, over every point) and the f32 rounding of the KNN's
    formula can explain: moving both ends by at most ``d`` changes a
    squared distance by at most 4 d r (r the row's largest distance on
    either side), twice over for the two swapped neighbours, and the
    formula |a|^2 + |b|^2 - 2 a.b rounds each side's value by less than
    8 x 2^-24 (|a|^2 + |b|^2): slack = 8 d r + 2^-20 S, S the row's
    largest |a|^2 + |b|^2. -> dict(rows, non_ties, worst: the largest
    excess over the farthest neighbour in slacks, 0.0 without a differing
    row, position_gap: d)."""
    import torch
    pa = torch.as_tensor(pts_a).detach().cpu().double()
    pb = torch.as_tensor(pts_b).detach().cpu().double()
    ia = torch.as_tensor(nn_a).cpu().long()
    ib = torch.as_tensor(nn_b).cpu().long()
    d = float((pa - pb).norm(dim=1).max())
    rows = torch.nonzero((ia.sort(1).values != ib.sort(1).values).any(1))
    rows = rows.flatten().tolist()
    non_ties, worst = [], 0.0
    for i in rows:
        both = torch.cat([ia[i], ib[i]])
        da = ((pa[both] - pa[i]) ** 2).sum(1)      # squared, side a
        db = ((pb[both] - pb[i]) ** 2).sum(1)
        r = float(torch.cat([da, db]).max().sqrt())
        big = float(torch.cat([(pa[both] ** 2).sum(1),
                               (pb[both] ** 2).sum(1)]).max())
        big += float(max((pa[i] ** 2).sum(), (pb[i] ** 2).sum()))
        slack = 8 * d * r + 2.0 ** -20 * big
        k = len(ia[i])
        excess = 0.0
        for dist, own, other in ((da, slice(0, k), slice(k, None)),
                                 (db, slice(k, None), slice(0, k))):
            held = set(both[own].tolist())
            swapped = [j for j, v in enumerate(both[other].tolist())
                       if v not in held]
            far = float(dist[own].max())
            for j in swapped:
                excess = max(excess, float(dist[other][j]) - far)
        ratio = excess / slack if slack > 0 else (math.inf if excess > 0
                                                  else 0.0)
        worst = max(worst, ratio)
        if ratio > 1.0:
            non_ties.append(i)
    return dict(rows=len(rows), non_ties=non_ties, worst=worst,
                position_gap=d)


def moran_gaps(report, cpu):
    """{key: |report - CPU| / (|CPU| + 0.1)} of two Moran reports."""
    return {k: abs(report[k] - v) / (abs(v) + 0.1) for k, v in cpu.items()}


def phase19_failures(field_gap, report, cpu_on_card, flips):
    """Why phase 19's SplatFields3D check fails ([]: it passes): the field
    outputs card against CPU (``field_gap``, {output: largest gap over the
    largest value}) past TOL_FIELD; Moran's I on the CPU over the card's
    neighbourhoods and inputs (``cpu_on_card``) past TOL_MORAN of the
    card's ``report``; a neighbourhood flip that is not a near tie
    (``flips``, ``neighbour_flips``)."""
    out = []
    worst = max(field_gap.values())
    if not worst <= TOL_FIELD:
        out.append(f"field outputs card against CPU {worst:.3e} of the "
                   f"largest value > {TOL_FIELD}")
    if set(report) != set(cpu_on_card):
        out.append(f"Moran keys {sorted(report)} against "
                   f"{sorted(cpu_on_card)}")
    else:
        gap = max(moran_gaps(report, cpu_on_card).values())
        if not gap <= TOL_MORAN:
            out.append(f"Moran's I on equal inputs {gap:.3e} > {TOL_MORAN}")
    if flips["non_ties"]:
        out.append(f"{len(flips['non_ties'])} of {flips['rows']} differing "
                   f"neighbourhoods are not near ties (worst "
                   f"{flips['worst']:.3g} slacks, rows "
                   f"{flips['non_ties'][:5]})")
    return out


def moran_equal_inputs(ply, model, it, hidden, report, cpu_attrs, cpu_pts,
                       cpu_nn, dev, smi):
    """Phase 19's SplatFields3D check of the card's ``extract_geo`` report
    (``phase19_failures``): the card's field outputs of the saved state
    against the CPU's (``cpu_attrs``, ``cpu_pts``), Moran's I on the CPU
    (``knn.neighbourhood_weights`` of the card's positions) over the
    card's own neighbourhoods and outputs against ``report``, and
    the card's neighbourhoods against the CPU's (``cpu_nn``, on its own
    outputs) by ``neighbour_flips``; then its witnesses, which must fail:
    the card's field outputs with the bf16 MLP (the JAX package's ``auto``
    for a static field) against the CPU's f32 ones, and a neighbour
    swapped for a far point. Also prints the field gap card against CPU
    with cuDNN's TF32 (torch's default: what a run without ``main``'s
    settings sees)."""
    import torch

    from splatfields_torch import extract_geo
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops import knn as knn_ops
    params, stats, _ = splats.load_ply(ply, device=dev)
    deform = DeformModel(hidden, radius=1.0, device=dev)
    deform.load_weights(model, it)

    def field_gap(attrs, pts, ref_attrs, ref_pts):
        """Largest |card - CPU| over the CPU's largest |value|, per output."""
        out = {k: float((attrs[k].cpu() - v).abs().max() / v.abs().max())
               for k, v in ref_attrs.items()}
        out["means"] = float((pts.cpu() - ref_pts).abs().max()
                             / ref_pts.abs().max())
        return out

    attrs, pts = extract_geo.moran_inputs(params, stats, deform, 0)
    w, card_nn = knn_ops.query_nn(pts, n_neighbors=5)
    card = extract_geo.morans_of(attrs, w, card_nn)
    # the weights again on the CPU, from the card's positions and
    # neighbourhoods: a fault in the card's weight arithmetic shows here
    cpu_w = knn_ops.neighbourhood_weights(pts.cpu(), card_nn.cpu())
    w_gap = float((w.cpu() - cpu_w).abs().max() / cpu_w.abs().max())
    cpu_on_card = extract_geo.morans_of({k: v.cpu() for k, v in attrs.items()},
                                        cpu_w, card_nn.cpu())
    f32_gap = field_gap(attrs, pts, cpu_attrs, cpu_pts)
    flips = neighbour_flips(pts, card_nn, cpu_pts, cpu_nn)
    other = {}
    tf32 = torch.backends.cudnn.allow_tf32
    with Env({"SPLATFIELDS_MLP_BF16": "on"}):
        for label, mlp, conv_tf32 in (("TF32 convs", "off", True),
                                      ("bf16 MLP", "on", False)):
            os.environ["SPLATFIELDS_MLP_BF16"] = mlp
            torch.backends.cudnn.allow_tf32 = conv_tf32
            try:
                got = extract_geo.moran_inputs(params, stats, deform, 0)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            if label == "bf16 MLP":   # the witness: bf16 on the card alone
                bf16_gap = field_gap(*got, cpu_attrs, cpu_pts)
            else:
                other[label] = field_gap(*got, cpu_attrs, cpu_pts)
    failures = phase19_failures(f32_gap, report, cpu_on_card, flips)
    # the witnesses: a known fault in the field, a neighbour that is no tie
    bf16_fails = phase19_failures(bf16_gap, report, cpu_on_card, flips)
    row = int(cpu_nn.shape[0] // 2)
    far = int(((pts.cpu().double() - pts[row].cpu().double()) ** 2).sum(1)
              .argmax())
    swapped = card_nn.cpu().clone()
    swapped[row, -1] = far
    swap_fails = phase19_failures(
        f32_gap, report, cpu_on_card,
        neighbour_flips(pts, swapped, cpu_pts, cpu_nn))
    print(f"phase 19 SplatFields3D: field outputs card against CPU, largest "
          f"gap over the largest value {f32_gap} (TOL_FIELD {TOL_FIELD}); "
          f"Moran's I on the CPU (its own weights) over the card's "
          f"neighbourhoods and outputs {cpu_on_card}, |diff| / (|CPU| + 0.1) "
          f"against the report "
          f"{moran_gaps(report, cpu_on_card)} (TOL_MORAN {TOL_MORAN}); the "
          f"card's own recomputation {card}; the weights card against "
          f"CPU {w_gap:.4g} of the largest; neighbourhoods card against "
          f"CPU: {flips['rows']} of {card_nn.shape[0]} rows differ, "
          f"{len(flips['non_ties'])} not near ties, worst "
          f"{flips['worst']:.4g} of the slack, position gap "
          f"{flips['position_gap']:.4g}; witnesses: the "
          f"card's field with the bf16 MLP against "
          f"the CPU's f32 {bf16_gap}: {bf16_fails}, row {row}'s last "
          f"neighbour swapped for point {far} {swap_fails}; field outputs "
          + ", ".join(f"with {k} {v}" for k, v in other.items()) + f"; {smi}")
    if failures:
        raise AssertionError(f"phase 19 SplatFields3D: {failures}")
    if not (bf16_fails and swap_fails):
        raise AssertionError("phase 19 SplatFields3D: a witness passed the "
                             "check")


def static_phases(dev, smi):
    """Phases 18-22: the Moran line, extract_geo, run_dtu.sh, card against
    CPU, and the render CLI's LPIPS. Returns ({kernel name: {phase:
    launches}}, {phase: check_loop_blends' errors}, {phase:
    check_partial_tiles' errors})."""
    import argparse
    import shutil
    import time

    import torch

    from splatfields_torch import extract_geo, render, train
    from splatfields_torch.data import png
    from splatfields_torch.metrics import read_results
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops import knn as knn_ops
    from splatfields_torch.ops.lpips import load_lpips
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.utils.system import search_for_max_iteration

    here = os.path.dirname(os.path.abspath(__file__))
    proto = os.path.join(here, "build", "blender_protocol")
    base = os.path.join(here, "build", "static_protocol")
    shutil.rmtree(base, ignore_errors=True)
    root = os.path.join(proto, "lego")
    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs, partial_errs = {}, {}

    def counted(phase, want_fwd, want_bwd):
        torch.cuda.synchronize()
        got = (blend_fwd.launches, blend_bwd.launches)
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        if got != (want_fwd, want_bwd):
            raise AssertionError(f"phase {phase}: blend launches {got}; want "
                                 f"{(want_fwd, want_bwd)}")

    # --- 18. run_blender.sh's Moran line ------------------------------------
    out = os.path.join(base, "3DGS_Lmoran")
    evals = len(PROTOCOL_TEST_THETAS) + 5
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with LoopBlends() as cap, CorrTimer() as corr:
        res = train.main(["-s", root, "-m", out] + PROTOCOL_MORAN
                         + ["--iterations", str(MORAN_ITERS),
                            "--test_iterations", "1", str(MORAN_ITERS)])
    counted("18", MORAN_ITERS + 2 * evals, MORAN_ITERS)
    on_card("phase 18", {**dict(vars(res.params)), **dict(vars(res.stats))})
    corr_ms, seen = corr.summary()
    if len(corr_ms) != MORAN_ITERS:
        raise AssertionError(f"phase 18: {len(corr_ms)} Moran terms in "
                             f"{MORAN_ITERS} steps")
    term_ms = float(np.mean(corr_ms[1:]))
    # the KNN's least time: per pair a float64 dot (3 multiplies, 2 adds)
    # and the f32 formula and top-k compare (2 adds, 1 multiply, 1
    # compare), all at 67 TFLOP/s; its bytes (positions in, k indices
    # out) are negligible
    knn_bound_ms = seen[0][0] ** 2 * 9 / F32_FLOPS * 1e3
    psnr = dict(read_metrics(out)["test/loss_viewpoint - psnr"])
    if not psnr[MORAN_ITERS] > psnr[1]:
        raise AssertionError(f"phase 18: test PSNR {psnr}")
    print(f"phase 18: 3DGS + Moran (--lambda_corr 0.01) {MORAN_ITERS} "
          f"iterations, {res.ms_per_it:.3f} ms/it, step {res.step_ms:.3f} ms "
          f"mean; the Moran term (KNN of every splat, query_nn, four Moran "
          f"sums; forward, CUDA events) {term_ms:.3f} ms a step (first "
          f"{corr_ms[0]:.3f}), {term_ms / res.step_ms:.4f} of the step; its "
          f"KNN's bound {knn_bound_ms:.4f} ms (operations); KNN "
          f"over (capacity, valid) {seen[0]} at the first step, {seen[-1]} "
          f"at the last; test PSNR {psnr[1]:.3f} at 1 -> "
          f"{psnr[MORAN_ITERS]:.3f} at {MORAN_ITERS}; blend "
          f"launches {blend_fwd.launches} fwd, {blend_bwd.launches} bwd; "
          f"{smi}")
    loop_errs["18"] = check_loop_blends("phase 18", cap)
    del cap, res
    blend_fwd.launches = blend_bwd.launches = 0
    with CorrTimer() as corr4:
        res4 = train.main(["-s", root, "-m", out + "_interval4"]
                          + PROTOCOL_MORAN
                          + ["--iterations", "8", "--corr_interval", "4",
                             "--test_iterations", "-1"])
    counted("18 interval 4", 8, 8)
    if len(corr4.calls) != 2:
        raise AssertionError(f"phase 18: --corr_interval 4 ran the Moran "
                             f"term {len(corr4.calls)} times in 8 steps")
    print(f"phase 18, --corr_interval 4: 8 steps, the Moran term (and its "
          f"KNN) at 2 of them, {corr4.summary()[0]} ms; step "
          f"{res4.step_ms:.3f} ms mean")
    del res4

    # --- 19. extract_geo ------------------------------------------------------
    for name, model in (("3DGS", os.path.join(proto, "out", "3DGS")),
                        ("SplatFields3D",
                         os.path.join(proto, "out", "SplatFields"))):
        torch.cuda.synchronize()
        t0 = time.time()
        report = extract_geo.main(["-m", model, "--mesh_resolution",
                                   str(MESH_RES), "--mesh_threshold",
                                   str(MESH_THRESHOLD)])
        torch.cuda.synchronize()
        geo_s = time.time() - t0
        it = search_for_max_iteration(os.path.join(model, "point_cloud"))
        with open(os.path.join(model, f"MoransI_iteration_{it}.yaml")) as f:
            text = f.read()
        if not (text == extract_geo.yaml_text(report) and len(report) == 4):
            raise AssertionError(f"phase 19 {name}: MoransI yaml {text!r}")
        verts, faces = mesh_counts(os.path.join(model,
                                                f"mesh_iteration_{it}.ply"))
        if not (verts > 0 and faces > 0):
            raise AssertionError(f"phase 19 {name}: empty mesh")
        # the port on the CPU, from the same saved state
        ply = os.path.join(model, "point_cloud", f"iteration_{it}",
                           "point_cloud.ply")
        params, stats, _ = splats.load_ply(ply, device="cpu")
        deform = None
        if name != "3DGS":
            hidden = train.cfg_lib.extract_configs(argparse.Namespace(
                **train.cfg_lib.load_cfg_args(model)))[2]
            deform = DeformModel(hidden, radius=1.0, device="cpu")
            deform.load_weights(model, it)
        attrs, pts = extract_geo.moran_inputs(params, stats, deform, 0)
        w, nn_ix = knn_ops.query_nn(pts, n_neighbors=5)
        cpu = extract_geo.morans_of(attrs, w, nn_ix)
        gap = moran_gaps(report, cpu)
        print(f"phase 19 {name}: extract_geo at iteration {it}, "
              f"{int(stats.valid.sum())} splats, mesh {MESH_RES}^3 -> {verts} "
              f"vertices, {faces} faces, {geo_s:.3f} s (scene load "
              f"included); MoransI {report}; the CPU's on its own inputs "
              f"{cpu}; |diff| / (|CPU| + 0.1) {gap}; {smi}")
        if deform is None:
            # 3DGS's report reads the PLY alone: its inputs are equal
            if not (set(cpu) == set(report)
                    and max(gap.values()) <= TOL_MORAN):
                raise AssertionError(f"phase 19 {name}: card and CPU differ")
        else:
            moran_equal_inputs(ply, model, it, hidden, report, attrs,
                               pts, nn_ix, dev, smi)
        del params, stats, deform, attrs, pts, w, nn_ix

    # --- 20. run_dtu.sh -------------------------------------------------------
    t0 = time.time()
    dtu = write_dtu_scene(base, *DTU_SIZE, DTU_VIEWS, dev)
    print(f"phase 20: synthetic DTU scan, {DTU_VIEWS} views of "
          f"{DTU_SIZE[0]}x{DTU_SIZE[1]} with masks, written in "
          f"{time.time() - t0:.2f} s")
    out_3dgs = os.path.join(base, "dtu", "3DGS")
    out_field = os.path.join(base, "dtu", "SplatFields3D")
    pc = os.path.join(out_3dgs, "point_cloud", f"iteration_{DTU_ITERS}",
                      "point_cloud.ply")
    w, h = DTU_SIZE[0] // 2, DTU_SIZE[1] // 2
    for name, argv, iters in (
            ("3DGS", ["-s", dtu, "-m", out_3dgs] + DTU_3DGS, DTU_ITERS),
            ("SplatFields3D", ["-s", dtu, "-m", out_field, "--pc_path", pc]
             + DTU_FIELD, DTU_FIELD_ITERS)):
        argv = argv + ["--iterations", str(iters)]
        phase = f"20 {name}"
        blend_fwd.launches = blend_bwd.launches = 0
        with LoopBlends() as cap:
            res = train.main(argv)
        counted(phase, iters, iters)
        on_card(f"phase {phase}",
                {**dict(vars(res.params)), **dict(vars(res.stats))})
        ms_it, step_ms, growth = res.ms_per_it, res.step_ms, res.dup_growth
        del res
        loop_errs[phase] = check_loop_blends(f"phase {phase}", cap)
        partial_errs[phase] = check_partial_tiles(f"phase {phase}", cap, w, h)
        del cap
        blend_fwd.launches = 0
        t0 = time.time()
        results = render.main(argv)
        torch.cuda.synchronize()
        render_s = time.time() - t0
        if blend_fwd.launches != DTU_VIEWS:
            raise AssertionError(f"phase {phase}: render launched "
                                 f"{blend_fwd.launches} blends")
        ours = os.path.join(argv[3], "train", f"ours_{iters}")
        got = read_results(os.path.join(ours, "results.yaml"))
        if not (results["train"]["psnr"] == got["psnr"]
                and np.isfinite(got["psnr"])):
            raise AssertionError(f"phase {phase}: render.py PSNR {got}")
        print(f"phase {phase}: {iters} iterations at {w}x{h} (-r 2 of "
              f"{DTU_SIZE[0]}x{DTU_SIZE[1]}), {ms_it:.3f} ms/it, step "
              f"{step_ms:.3f} ms mean, dup_factor growth {growth}; render CLI "
              f"{DTU_VIEWS} train views in {render_s:.3f} s, PSNR "
              f"{got['psnr']:.3f}, SSIM {got['ssim']:.3f}; {smi}")

    # --- 21. card against CPU: the Moran and DTU lines ------------------------
    small = os.path.join(proto, "small", "lego")
    card_vs_cpu("phase 21 Moran",
                ["-s", small, "--white_background", "--eval", "--is_static",
                 "--n_views", "4", "--pts_samples", "hull", "--num_pts",
                 "2000", "--lambda_corr", "0.01", "--load_time_step", "0",
                 "--composition_rank", "0"],
                os.path.join(base, "small_out", "moran"), dev, iters=3)
    dtu_small = write_dtu_scene(os.path.join(base, "dtu_small"), 160, 120,
                                3, torch.device("cpu"), n_splats=3000)
    card_vs_cpu("phase 21 DTU 3DGS",
                ["-s", dtu_small, "--num_pts", "2000"] + DTU_3DGS,
                os.path.join(base, "small_out", "dtu"), dev, iters=3)

    # --- 22. the render CLI with --lpips_weights ------------------------------
    weights = write_lpips_weights(os.path.join(base, "lpips_vgg.npz"))
    argv = (["-s", dtu, "-m", out_3dgs] + DTU_3DGS
            + ["--iterations", str(DTU_ITERS), "--lpips_weights", weights])
    render.main(argv)
    ours = os.path.join(out_3dgs, "train", f"ours_{DTU_ITERS}")
    card = read_results(os.path.join(ours, "results.yaml"))["lpips"]
    cpu_fn, card_fn = load_lpips(weights, "cpu"), load_lpips(weights)
    vals, pair = [], None
    for i in range(DTU_VIEWS):
        pair = [png.read(os.path.join(ours, sub, f"{i:05d}.png"))[..., 2::-1]
                / np.float32(255) for sub in ("renders", "gt")]
        vals.append(cpu_fn(*pair) * 100)
    lpips_ms = cuda_ms(lambda: card_fn(*pair), 5)
    rel = abs(card - np.mean(vals)) / abs(np.mean(vals))
    print(f"phase 22: render CLI with --lpips_weights (seeded random VGG16 "
          f"weights): results.yaml lpips {card}, the CPU's {np.mean(vals)}, "
          f"rel {rel:.3e}; the last pair on the card {card_fn(*pair)!r}, on "
          f"the CPU {cpu_fn(*pair)!r}; LPIPS of one {w}x{h} pair on the "
          f"card {lpips_ms:.3f} ms (upload included); {smi}")
    if not (card is not None and rel <= 1e-4):
        raise AssertionError("phase 22: lpips differs between card and CPU")
    return launches, loop_errs, partial_errs


OWLII_HIDDEN = dict(encoder_type="VarTriPlaneEncoder", composition_rank=40,
                   n_frames=100, flow_model="offset")
OWLII_FRAMES = 100
# phase 25's scene: its frames go through the render CLI's host metrics
# (scipy SSIM) in the time limit at this resolution and this many frames
# (run_owlii.sh's TIME_STEP, 100 by default: 220 frames rendered, not
# 1,100)
OWLII_RES = 160
OWLII_PROTOCOL_FRAMES = 10
OWLII_ITERS = 30
OWLII_DENSIFY = 15       # densify_from_iter and densification_interval
OWLII_PROFILE = (15, 5)  # iterations 16-20 timed, 21-25 profiled
OWLII_MESH_RES = 64
OWLII_ENV = {}           # further run_owlii.sh variables (the defaults)
OWLII_GT_SPLATS = 30_000
OWLII_STEPS = {1: 10, 5: 6}   # timed steps at each num_views


def owlii_batch(cams, fid, rng, device):
    """V views' batch for make_train_step at time step ``fid``: random
    targets."""
    import torch

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    res = cams[0].image_width
    return {"viewmatrix": f32([c.world_view_transform for c in cams]),
            "projmatrix": f32([c.full_proj_transform for c in cams]),
            "campos": f32([c.camera_center for c in cams]),
            "tanfovx": [c.tanfovx for c in cams],
            "tanfovy": [c.tanfovy for c in cams], "fid": fid,
            "image": f32(rng.rand(len(cams), 3, res, res)),
            "bg": f32(np.ones(3))}


def device_idle(fn):
    """(wall ms without the profiler, device-busy ms, idle share, top
    device events) of ``fn()``, which ends in a synchronize."""
    import time

    import torch
    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:80])
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms, rows[:12]


class Timed:
    """Inside ``with``: the wall seconds of every call of the ``loader``
    dataset loader (``reader``, carve included), ``visual_hull_samples``
    (``carve``), the render CLI's ``Scene`` (``scene``) and its
    ``metrics.eval_all`` (``metrics``: PNG reads and scipy SSIM)."""

    def __init__(self, loader="ResFields"):
        self.loader = loader

    def __enter__(self):
        import time

        from splatfields_torch import metrics, render
        from splatfields_torch.data import registry
        from splatfields_torch.data.readers import neus
        self.times = {k: [] for k in ("reader", "carve", "scene", "metrics")}
        self.saved = (registry.SCENE_LOADERS[self.loader],
                      neus.visual_hull_samples, render.Scene,
                      metrics.eval_all)

        def timed(fn, into):
            def wrapper(*a, **k):
                t0 = time.time()
                out = fn(*a, **k)
                self.times[into].append(time.time() - t0)
                return out
            return wrapper

        registry.SCENE_LOADERS[self.loader] = timed(self.saved[0], "reader")
        neus.visual_hull_samples = timed(self.saved[1], "carve")
        render.Scene = timed(self.saved[2], "scene")
        metrics.eval_all = timed(self.saved[3], "metrics")
        return self

    def seconds(self, key):
        return sum(self.times[key])

    def __exit__(self, *exc):
        from splatfields_torch import metrics, render
        from splatfields_torch.data import registry
        from splatfields_torch.data.readers import neus
        (registry.SCENE_LOADERS[self.loader], neus.visual_hull_samples,
         render.Scene, metrics.eval_all) = self.saved


class LoopProfile:
    """Inside ``with``: the training loop's own iterations, whole (step,
    batch, loss read, schedules), in two adjacent windows of ``n`` after
    iteration ``start``: the first timed on the host clock, the second
    under ``torch.profiler`` -> ``ms_per_it``, ``busy_ms`` (device time an
    iteration), ``idle`` (1 - busy / wall), ``top`` (device events), and
    ``rebuilt``: steps the loop built inside the windows (a grown
    dup_factor or capacity, which makes the windows' work differ)."""

    def __init__(self, start, n):
        self.start, self.n = start, n
        self.calls = self.builds = self.builds0 = 0
        self.rebuilt = self.t0 = self.prof = None
        self.ms_per_it = self.busy_ms = self.idle = None
        self.top = []

    def __enter__(self):
        import time

        import torch

        from splatfields_torch import train_lib
        self.make = train_lib.make_train_step
        timed, profiled, end = (self.start, self.start + self.n,
                                self.start + 2 * self.n)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

        def make(*a, **k):
            step = self.make(*a, **k)
            self.builds += 1

            def counted(*sa):
                if self.calls in (timed, profiled, end):
                    torch.cuda.synchronize()
                    now = time.perf_counter()
                if self.calls == timed:
                    self.t0, self.builds0 = now, self.builds
                elif self.calls == profiled:
                    self.ms_per_it = (now - self.t0) * 1e3 / self.n
                    self.prof = torch.profiler.profile(activities=acts)
                    self.prof.__enter__()
                elif self.calls == end:
                    self.prof.__exit__(None, None, None)
                    self.rebuilt = self.builds - self.builds0
                    self._report()
                self.calls += 1
                return step(*sa)
            return counted

        train_lib.make_train_step = make
        return self

    def _report(self):
        import torch
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:80])
                       for e in self.prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        self.busy_ms = sum(r[0] for r in rows) / self.n
        self.idle = 1 - self.busy_ms / self.ms_per_it
        self.top = rows[:12]
        self.prof = None

    def __exit__(self, *exc):
        from splatfields_torch import train_lib
        train_lib.make_train_step = self.make


def owlii_step(dev, smi, views, sc_pts, sc_cols, hidden=None, label=None):
    """Phase 23 at ``views`` views a step: bench.py --variant owlii4d
    (phase 29: with ``hidden``'s encoder). Returns (launches,
    check_loop_blends' errors, ms/step)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.render_lib import render_camera

    label = label or f"phase 23, {views} view{'s' if views > 1 else ''}"
    hidden = hidden or OWLII_HIDDEN
    deform = DeformModel(config.HiddenConfig(**hidden), radius=1.0,
                         seed=0, device=dev)
    pipe = config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128)
    step = train_lib.make_train_step(
        deform.net, config.OptimizationConfig(lambda_mask=0.0,
                                              lambda_norm=0.01),
        pipe, RES, RES, views, True, OWLII_FRAMES, 0)
    sp, st = splats.create_from_pcd(sc_pts, sc_cols, 0, capacity=N_SPLATS,
                                    device=dev)
    sopt, fp, fopt = splats.adam_init(sp), deform.params, deform.opt_state
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    rng = np.random.RandomState(views)
    n_steps = TRAIN_WARMUP + OWLII_STEPS[views]
    frames = np.resize(rng.permutation(OWLII_FRAMES), n_steps + 4)
    cams = make_views(views * (n_steps + 4), RES)
    batches = [owlii_batch(cams[views * i: views * (i + 1)],
                           float(f) / (OWLII_FRAMES - 1), rng, dev)
               for i, f in enumerate(frames)]
    rank_keys = [k for k in fp if k.endswith(".weights_t")]
    # per-frame conv deltas (layer_strategy per_frame): [frames, ...]
    delta_keys = [k for k in fp if k.endswith(".frame_weights")]
    if not (len(rank_keys) > 0 and all(
            fp[k].shape == (OWLII_FRAMES, 40) for k in rank_keys)):
        raise AssertionError(f"{label}: ResField ranks {rank_keys}")
    fp0 = {k: v.clone() for k, v in fp.items()}
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    for i, b in enumerate(batches[:n_steps]):
        if i == TRAIN_WARMUP:
            start.record()
        sp, st, sopt, fp, fopt, out = step(sp, st, sopt, fp, fopt, b, lrs,
                                           FIELD_LR)
        losses.append(out.loss)
        if i == 0:
            # Adam from zero moments: a row without gradient stays put
            frame = int(round(b["fid"] * (OWLII_FRAMES - 1)))
            for k in rank_keys:
                moved = (fp[k] != fp0[k]).any(dim=1)
                if not (bool(moved[frame]) and int(moved.sum()) == 1):
                    raise AssertionError(
                        f"{label}: {k} rows moved {moved.nonzero().tolist()}"
                        f", want [{frame}]")
            if not all(bool((fp[k] != fp0[k]).any()) for k in fp
                       if k.endswith(".matrix_t")):
                raise AssertionError(f"{label}: a matrix_t did not move")
            # the per-frame deltas: none moves outside the frame, and the
            # frame's moves wherever the gradient reaches
            outside = reached = 0
            for k in delta_keys:
                moved = (fp[k] != fp0[k]).flatten(1).any(dim=1)
                outside += int(moved.sum()) - int(moved[frame])
                reached += int(moved[frame])
            if outside or (delta_keys and not reached):
                raise AssertionError(
                    f"{label}: per-frame deltas moved in {outside} rows "
                    f"outside frame {frame}, in {reached} of "
                    f"{len(delta_keys)} convs at it")
            delta_note = (f"; per-frame conv deltas: {len(delta_keys)} "
                          f"convs x {OWLII_FRAMES} frames, {outside} rows "
                          f"moved outside frame {frame}, {reached} convs' "
                          f"row {frame} moved" if delta_keys else "")
    end.record()
    torch.cuda.synchronize()
    launches = (blend_fwd.launches, blend_bwd.launches)
    if launches != (views * n_steps, views * n_steps):
        raise AssertionError(f"{label}: blend launches {launches} for "
                             f"{n_steps} steps of {views} views")
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}: losses {losses.tolist()}")
    step_ms = start.elapsed_time(end) / OWLII_STEPS[views]

    state = [sp, st, sopt, fp, fopt]

    def run3():
        for b in batches[n_steps:n_steps + 3]:
            state[:5] = step(*state, b, lrs, FIELD_LR)[:5]
        torch.cuda.synchronize()

    wall_ms, busy_ms, idle, top = device_idle(run3)
    encoder = hidden["encoder_type"] + (
        f" {hidden['layer_strategy']}" if "layer_strategy" in hidden else "")
    print(f"{label}: bench.py --variant owlii4d ({N_SPLATS} splats, "
          f"{encoder}, rank-40 ResField heads, {OWLII_FRAMES} frames, "
          f"offset flow, {RES}x{RES}, lambda_norm 0.01), a different fid "
          f"each step; {step_ms:.4f} ms/step, rays/s "
          f"{views * RES * RES / step_ms * 1e3:.1f} ({OWLII_STEPS[views]} "
          f"steps after {TRAIN_WARMUP} warm-up); losses "
          f"{[round(x, 6) for x in losses.tolist()]}; blend launches "
          f"{launches} for {n_steps} steps; after the first step only "
          f"weights_t[frame] moved in {len(rank_keys)} ResField layers"
          f"{delta_note}; 3 profiled steps: wall {wall_ms:.3f} ms, GPU busy "
          f"{busy_ms:.3f} ms, GPU idle share {idle:.4f}; {smi}")
    print(f"{label}: top device events (ms over 3 steps, calls): "
          + "; ".join(f"{k} {ms:.3f} ({c})" for ms, c, k in top))
    # both kernels on this step's own inputs and an evaluation frame's
    with LoopBlends() as cap:
        state[:5] = step(*state, batches[n_steps + 3], lrs, FIELD_LR)[:5]
        eval_cam = dataclasses.replace(cams[0], fid=batches[0]["fid"])
        render_camera(eval_cam, state[0], state[1], deform, pipe,
                      np.ones(3, np.float32), n_frames=OWLII_FRAMES)
    torch.cuda.synchronize()
    errs = check_loop_blends(label, cap)
    return launches, errs, step_ms


def owlii_phases(dev, smi):
    """Phases 23-26: the Owlii 4D protocol. Returns ({kernel name: {phase:
    launches}}, {phase: check_loop_blends' errors})."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats

    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs = {}
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (N_SPLATS, 3)).astype(np.float32)
    cols = rng.rand(N_SPLATS, 3).astype(np.float32)

    # --- 23. the 4-D step at full width, 1 and 5 views ---------------------
    for views in (1, 5):
        phase = f"23 V{views}"
        got, loop_errs[phase], _ = owlii_step(dev, smi, views, pts, cols)
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        torch.cuda.empty_cache()

    # --- 24. a small 4-D step on the card and on the CPU ---------------------
    res = {}
    cams = make_views(3, 64)[1:]
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        net = small_4d_net(device)
        p_, s_ = splats.create_from_pcd(pts[:2000], cols[:2000], 0,
                                        device=device)
        fp = {k: v.detach() for k, v in net.named_parameters()}
        step = train_lib.make_train_step(
            net, config.OptimizationConfig(lambda_mask=0.0,
                                           lambda_norm=0.01),
            config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128),
            64, 64, 2, True, SMALL_4D["n_frames"], 0)
        res[name] = step(p_, s_, nonzero_adam(p_, 1), fp,
                         nonzero_adam(fp, 2),
                         owlii_batch(cams, 2 / 3, np.random.RandomState(1),
                                     device),
                         splats.splat_lr_tree(*SPLAT_LRS), FIELD_LR)
    print("phase 24: a small 4-D step (chip_smoke.SMALL_4D, 2,000 splats, "
          "64x64, 2 views, fid 2/3), card against CPU:")
    check_small_step(res["cuda"], res["cpu"])
    del res

    launches_25, loop_errs["25"] = owlii_protocol(dev, smi)
    for k in launches:
        launches[k]["25"] = launches_25[k]
    owlii_card_vs_cpu(dev)
    return launches, loop_errs


def owlii_protocol(dev, smi):
    """Phase 25; returns ({kernel name: launches}, check_loop_blends'
    errors)."""
    import glob
    import shutil
    import time

    import torch

    from splatfields_torch import extract_geo, render, train
    from splatfields_torch.metrics import read_results
    from splatfields_torch.models.splatfields import frame_id_of
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.utils.system import search_for_max_iteration

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "owlii_protocol")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.time()
    scene = write_owlii_scene(base, OWLII_RES, OWLII_PROTOCOL_FRAMES, dev,
                              n_splats=OWLII_GT_SPLATS)
    torch.cuda.synchronize()
    print(f"phase 25: ResFields scene at {OWLII_RES}x{OWLII_RES} (the "
          f"resolution that keeps the phase in time), "
          f"{OWLII_PROTOCOL_FRAMES} frames "
          f"of {OWLII_TRAIN_CAMS} cam_train_* and cam_test, "
          f"{OWLII_GT_SPLATS} moving ground-truth splats, written in "
          f"{time.time() - t0:.2f} s")
    out = os.path.join(base, "out")
    env = dict(OWLII_ENV, DATASET_ROOT=base, SCENE=os.path.basename(scene),
               OUT=out, ITERS=OWLII_ITERS, TIME_STEP=OWLII_PROTOCOL_FRAMES)
    train_argv, render_argv = owlii_command_lines(env)
    run = os.path.join(out, "8views", os.path.basename(scene),
                       "SplatFields4D")
    extra = ["--densify_from_iter", str(OWLII_DENSIFY),
             "--densification_interval", str(OWLII_DENSIFY),
             "--test_iterations", "1", str(OWLII_ITERS)]
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with Timed() as timed, LoopBlends() as cap, LoopProfile(
            *OWLII_PROFILE) as prof:
        res = train.main(train_argv + extra)
    torch.cuda.synchronize()
    # two evaluations: 25 test frames (of the test camera's
    # OWLII_PROTOCOL_FRAMES)
    # and 5 train frames each
    evals = 2 * (min(25, OWLII_PROTOCOL_FRAMES) + 5)
    got = (blend_fwd.launches, blend_bwd.launches)
    launches = {"blend_fwd": got[0], "blend_bwd": got[1]}
    if got != (5 * OWLII_ITERS + evals, 5 * OWLII_ITERS):
        raise AssertionError(f"phase 25: blend launches {got}; want "
                             f"{(5 * OWLII_ITERS + evals, 5 * OWLII_ITERS)}")
    on_card("phase 25", {**dict(vars(res.params)), **dict(vars(res.stats)),
                         **res.deform.params})
    if [d[0] for d in res.densified] != list(range(
            2 * OWLII_DENSIFY, OWLII_ITERS + 1, OWLII_DENSIFY)):
        raise AssertionError(f"phase 25: densified {res.densified}")
    m = read_metrics(run)
    psnr = dict(m["test/loss_viewpoint - psnr"])
    if not psnr[OWLII_ITERS] > psnr[1]:
        raise AssertionError(f"phase 25: test PSNR {psnr}")
    dropped = [int(v) for _, v in m.get("train_loss_patches/bin_dropped", [])]
    reader_s, carve_s = timed.seconds("reader"), timed.seconds("carve")
    print(f"phase 25: run_owlii.sh's train line (ITERS={OWLII_ITERS}, "
          f"{' '.join(extra)}), {res.ms_per_it:.3f} ms/it, step "
          f"{res.step_ms:.3f} ms mean ({OWLII_RES}x{OWLII_RES}, 5 views, "
          f"{int(res.stats.valid.sum())} splats at the end); test PSNR "
          f"{psnr[1]:.3f} at 1 -> {psnr[OWLII_ITERS]:.3f} at {OWLII_ITERS}; "
          f"densify (iteration, before, after, dropped) {res.densified}; "
          f"dup_factor growth (iteration, dropped, new factor) "
          f"{res.dup_growth}; instances dropped past dup_cap a step (every "
          f"10th): max {max(dropped, default=0)}; reader {reader_s:.3f} s "
          f"for {OWLII_PROTOCOL_FRAMES} frames of {OWLII_TRAIN_CAMS + 1} "
          f"cameras "
          f"(the carve included), 256^3 hull carve {carve_s:.3f} s;"
          f" blend launches {got}; {smi}")
    w0, n = OWLII_PROFILE[0] + 1, OWLII_PROFILE[1]
    print(f"phase 25: loop iterations {w0}-{w0 + n - 1}: "
          f"{prof.ms_per_it:.3f} ms/it on the host clock; iterations "
          f"{w0 + n}-{w0 + 2 * n - 1} profiled: GPU busy "
          f"{prof.busy_ms:.3f} ms/it, GPU idle share {prof.idle:.4f} (steps "
          f"rebuilt inside the windows: {prof.rebuilt}); top device events "
          f"(ms over {OWLII_PROFILE[1]} iterations, calls): "
          + "; ".join(f"{k} {ms:.3f} ({c})" for ms, c, k in prof.top))
    errs = check_loop_blends("phase 25", cap)
    del cap, res
    torch.cuda.empty_cache()
    t0 = time.time()
    with Timed() as timed:
        results = render.main(render_argv)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    it = search_for_max_iteration(os.path.join(run, "point_cloud"))
    n_render = sum(len(glob.glob(os.path.join(run, s, f"ours_{it}",
                                              "renders", "*.png")))
                   for s in ("train", "test"))
    yaml = read_results(os.path.join(run, "test", f"ours_{it}",
                                     "results.yaml"))
    if not (n_render == (OWLII_TRAIN_CAMS + 1) * OWLII_PROTOCOL_FRAMES
            and np.isfinite(yaml["psnr"]) and yaml["psnr"] > psnr[1]):
        raise AssertionError(f"phase 25: render CLI {n_render} frames, "
                             f"{yaml}, {results.keys()}")
    scene_s, metrics_s = timed.seconds("scene"), timed.seconds("metrics")
    print(f"phase 25: run_owlii.sh's render line, {n_render} frames at "
          f"{OWLII_RES}x{OWLII_RES} in {render_s:.3f} s "
          f"({render_s * 1000 / n_render:.1f} ms/frame): scene load "
          f"{scene_s:.3f} s, metrics (PNG reads, scipy SSIM) {metrics_s:.3f} "
          f"s ({metrics_s * 1000 / n_render:.1f} ms/frame), renders and PNG "
          f"writes {render_s - scene_s - metrics_s:.3f} s; test results.yaml "
          f"{yaml}; {smi}")
    t0 = time.time()
    report = extract_geo.main(["-m", run, "--mesh_resolution",
                               str(OWLII_MESH_RES)])
    torch.cuda.synchronize()
    verts, faces = mesh_counts(os.path.join(run, f"mesh_iteration_{it}.ply"))
    if not (len(report) == 4 and verts > 0 and faces > 0):
        raise AssertionError(f"phase 25: extract_geo {report}, mesh "
                             f"{verts}, {faces}")
    print(f"phase 25: extract_geo at fid 0 (frame "
          f"{frame_id_of(0.0, OWLII_PROTOCOL_FRAMES)}), "
          f"{time.time() - t0:.3f} s, "
          f"MoransI {report}, mesh {OWLII_MESH_RES}^3 -> {verts} vertices, "
          f"{faces} faces; {smi}")
    # the scene stays for phase 30
    shutil.rmtree(out, ignore_errors=True)
    return launches, errs


OWLII_SMALL_ARGV = ("--white_background --eval --load_time_step 2 "
                    "--flow_model offset --all_training --num_views 2 "
                    "--pts_samples hull --num_pts 2000 --encoder_type "
                    "VarTriPlaneEncoder --composition_rank 40").split()


def owlii_small_scene(root):
    """Phase 26's scene: 64x64, 2 frames, written on the CPU."""
    import torch
    return write_owlii_scene(root, 64, 2, torch.device("cpu"))


def owlii_card_vs_cpu(dev, iters=3):
    """Phase 26: ``resumed_card_vs_cpu`` of ``OWLII_SMALL_ARGV`` on
    ``owlii_small_scene``."""
    import shutil
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "owlii_small")
    shutil.rmtree(base, ignore_errors=True)
    return resumed_card_vs_cpu(
        "phase 26 run_owlii.sh (64x64, 2 frames, rank 40, 2 views)",
        ["-s", owlii_small_scene(base)] + OWLII_SMALL_ARGV, base, dev, iters)


def resumed_card_vs_cpu(label, argv, base, dev, iters=3):
    """An ``iters``-iteration loop of the command line ``argv`` (a 4-D
    run) on the CPU, and on the card each iteration k from the CPU's train
    state after k - 1 (``--resume``), run directories under ``base``: the
    losses of every iteration within phase 7's 1e-5 relative -> the
    worst. The CPU
    runs the loop twice, and the two runs' spread is printed: Adam from
    zero moments moves every ResField entry by its learning rate whatever
    the size of its gradient, so f32 noise in near-zero gradients
    compounds over free-running iterations (rank 40: ~1e-5 in 5, the CPU
    against itself), and the card is compared on shared states."""
    import random
    import shutil

    import torch

    from splatfields_torch import train

    def loop(name, device, last, resume=False):
        args = train.build_train_parser().parse_args(
            argv + ["-m", os.path.join(base, name), "--iterations",
                    str(last)])
        model, pipe, hidden, opt = train.cfg_lib.extract_configs(args)
        got = []
        train.training(model, hidden, opt, pipe, [],
                       list(range(1, last + 1)), quiet=True,
                       rng=random.Random(0), device=device, resume=resume,
                       progress_callback=lambda it, loss, *_: got.append(
                           loss))
        return got

    cpu = np.array(loop("cpu", "cpu", iters))
    again = np.array(loop("cpu_again", "cpu", iters))
    card = []
    for k in range(1, iters + 1):
        name = f"card_{k}"
        if k > 1:
            src = os.path.join(base, "cpu", "train_state",
                               f"iteration_{k - 1}")
            dst = os.path.join(base, name, "train_state",
                               f"iteration_{k - 1}")
            shutil.copytree(src, dst)
            # a CPU generator's state does not load into the card's; the
            # densify noise is not drawn in these iterations
            state = torch.load(os.path.join(dst, "state.pt"),
                               weights_only=True)
            state["densify_rng"] = torch.Generator(
                device=dev).manual_seed(0).get_state()
            torch.save(state, os.path.join(dst, "state.pt"))
        got = loop(name, dev, k, resume=k > 1)
        if len(got) != 1:
            raise AssertionError(f"{label}: iteration {k} ran {len(got)} "
                                 "iterations on the card")
        card.append(got[0])
    card = np.array(card)
    rel = np.abs(card - cpu) / np.abs(cpu)
    spread = np.abs(again - cpu) / np.abs(cpu)
    print(f"{label}: CPU "
          f"losses {cpu.tolist()}; the card's, each iteration from the "
          f"CPU's state before it, {card.tolist()}, worst rel "
          f"{rel.max():.3e}; the CPU run again, free-running, rel "
          f"{spread.tolist()}")
    if not rel.max() <= 1e-5:
        raise AssertionError(f"{label}: losses differ")
    shutil.rmtree(base, ignore_errors=True)
    return float(rel.max())


def card_vs_cpu(label, argv, out_root, dev, iters=3):
    """``train.training`` for ``iters`` iterations of the command line
    ``argv`` on the card and on the CPU with the same seeds: the losses of
    every iteration within phase 7's 1e-5 relative -> the worst."""
    import random

    from splatfields_torch import train
    losses = {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        args = train.build_train_parser().parse_args(
            argv + ["-m", os.path.join(out_root, name), "--iterations",
                    str(iters)])
        model, pipe, hidden, opt = train.cfg_lib.extract_configs(args)
        got = []
        train.training(model, hidden, opt, pipe, [], [], quiet=True,
                       rng=random.Random(0), device=device,
                       progress_callback=lambda it, loss, *_: got.append(
                           loss))
        losses[name] = np.array(got)
    rel = np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])
    print(f"{label}: losses card {losses['cuda'].tolist()}, CPU "
          f"{losses['cpu'].tolist()}, worst rel {rel.max():.3e}")
    if not (len(rel) == iters and rel.max() <= 1e-5):
        raise AssertionError(f"{label}: losses differ")
    return float(rel.max())


def check_small_step(card, cpu):
    """Phase 7's comparison. The card's convolutions and matmuls run in
    f32 (TF32 off) but sum in another order: the loss agrees to ~1e-6
    relative (rtol 1e-5); the screen-space gradient, a sum over pixels, to
    1e-4 of its max; a step moves a parameter by about its lr, so updated
    parameters get 1e-3 of the lr plus 1e-5 relative."""
    import torch

    from splatfields_torch.models import splats
    (sp_g, st_g, _, fp_g, _, out_g), (sp_c, st_c, _, fp_c, _, out_c) = card, cpu
    loss_g, loss_c = float(out_g.loss), float(out_c.loss)
    print(f"small step: loss card {loss_g:.7f}, CPU {loss_c:.7f}")
    if not abs(loss_g - loss_c) <= 1e-5 * abs(loss_c):
        raise AssertionError("small step: losses differ")
    if not torch.equal(out_g.radii.cpu(), out_c.radii):
        raise AssertionError("small step: radii differ between card and CPU")
    sg_c = out_c.screen_grad
    sg_err = float((out_g.screen_grad.cpu() - sg_c).abs().max()
                   / sg_c.abs().max())
    print(f"small step: screen_grad err over its max {sg_err:.3e}")
    if not sg_err <= 1e-4:
        raise AssertionError("small step: screen_grad differs")
    lrs = splats.tree_items(splats.splat_lr_tree(*SPLAT_LRS))
    worst = 0.0
    for tree_g, tree_c, lr_of in (
            (splats.tree_items(sp_g), splats.tree_items(sp_c), lrs.get),
            (fp_g, fp_c, lambda _: FIELD_LR)):
        for k, want in tree_c.items():
            err = float(((tree_g[k].cpu() - want).abs()
                         - 1e-5 * want.abs()).max()) if want.numel() else 0.0
            worst = max(worst, err / lr_of(k))
    print(f"small step: updated params, worst err over lr {worst:.3e}")
    if not worst <= 1e-3:
        raise AssertionError("small step: updated parameters differ")


# --- phases 27-31: the train CLI's field options ------------------------------
# phase 27: phase 6's field step (bench.py's default workload) with one
# option changed a field, at the widths the CLI builds by default
OPTION_STEPS = 6             # timed steps after TRAIN_WARMUP
OPTION_N_SPLATS = 50_000
OPTION_FIELDS = (
    ("TriPlaneEncoder", dict(encoder_type="TriPlaneEncoder"), -1),
    ("GridEncoder", dict(encoder_type="GridEncoder"), -1),
    ("VarTriPlane use_view_dep_rgb", dict(encoder_type="VarTriPlaneEncoder",
                                          use_view_dep_rgb=True), -1),
    ("VarTriPlane geo_model_disable_pts",
     dict(encoder_type="VarTriPlaneEncoder", geo_model_disable_pts=True),
     -1),
    (f"VarTriPlane n_splats {OPTION_N_SPLATS}",
     dict(encoder_type="VarTriPlaneEncoder"), OPTION_N_SPLATS))
# phase 28: the fused heads on the plans these fields give (feature width
# 48 from learned planes, 24 from the grid; mlp_rgb of 128 outputs)
FUSED_OPTIONS = OPTION_FIELDS[:3]
# phase 29: phase 23's 4-D step (1 view) with another encoder
HEX_OPTIONS = (
    ("VarHexPlaneEncoder per_frame", dict(
        OWLII_HIDDEN, encoder_type="VarHexPlaneEncoder",
        layer_strategy="per_frame")),
    ("HexPlaneEncoder", dict(OWLII_HIDDEN, encoder_type="HexPlaneEncoder")))
# phase 30: the CLIs with the new flags, cut in depth (iterations, and the
# Owlii frames) to keep the phase in time
OPTION_OWLII_FLAGS = ["--encoder_type", "VarHexPlaneEncoder",
                      "--layer_strategy", "per_frame"]
OPTION_OWLII_ITERS = 8
OPTION_OWLII_FRAMES = 5
OPTION_BLENDER_FLAGS = ["--encoder_type", "TriPlaneEncoder",
                        "--use_view_dep_rgb", "--n_splats",
                        str(OPTION_N_SPLATS)]
OPTION_BLENDER_ITERS = 30
# phase 31: a small static CLI run with the new flags, card against CPU
OPTION_SMALL_FLAGS = ["--encoder_type", "TriPlaneEncoder",
                      "--use_view_dep_rgb", "--geo_model_disable_pts",
                      "--lambda_norm", "0.01", "--pts_samples", "random"]
# phase 31's small 4-D net: SMALL_4D with VarHexPlane and per-frame deltas
SMALL_HEX = dict(SMALL_4D, encoder_type="VarHexPlaneEncoder",
                 layer_strategy="per_frame")


def option_step(dev, smi, label, hidden, n_splats, pts, cols, batches):
    """One phase-27 field: ``OPTION_STEPS`` timed steps after the warm-up,
    the GPU idle share over 3 profiled steps, and both blend kernels
    against their plain versions on a step's own inputs and an evaluation
    frame's. Returns (launches, check_loop_blends' errors)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.render_lib import render_camera

    deform = DeformModel(config.HiddenConfig(
        composition_rank=0, n_frames=0, **hidden), radius=1.0, seed=0,
        device=dev)
    pipe = config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128)
    step = train_lib.make_train_step(
        deform.net, config.OptimizationConfig(lambda_mask=0.0,
                                              lambda_norm=0.01),
        pipe, RES, RES, 1, True, 0, 0, n_splats=n_splats,
        generator=torch.Generator(device=dev).manual_seed(0))
    sp, st = splats.create_from_pcd(pts, cols, 0, capacity=N_SPLATS,
                                    device=dev)
    state = [sp, st, splats.adam_init(sp), deform.params, deform.opt_state]
    fp0 = {k: v.clone() for k, v in state[3].items()}
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    n_steps = TRAIN_WARMUP + OPTION_STEPS
    losses = []
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for i, b in enumerate(batches[:n_steps]):
        if i == TRAIN_WARMUP:
            start.record()
        *state, out = step(*state, b, lrs, FIELD_LR)
        losses.append(out.loss)
    end.record()
    torch.cuda.synchronize()
    launches = (blend_fwd.launches, blend_bwd.launches)
    if launches != (n_steps, n_steps):
        raise AssertionError(f"{label}: blend launches {launches} for "
                             f"{n_steps} steps")
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}: losses {losses.tolist()}")
    fp = state[3]
    moved = {k: float((fp[k] - fp0[k]).abs().max()) for k in fp}
    still = [k for k, m in moved.items() if m == 0
             and k.startswith(("encoder.", "refine", "rgb_viewdep"))]
    if still:
        raise AssertionError(f"{label}: parameters that did not move: "
                             f"{still}")
    rendered = N_SPLATS if n_splats <= 0 else n_splats
    seen = int((state[1].denom > 0).sum())
    if out.radii.shape[0] != rendered or seen > n_steps * rendered:
        raise AssertionError(f"{label}: {out.radii.shape[0]} splats "
                             f"rendered a step, {seen} seen")
    step_ms = start.elapsed_time(end) / OPTION_STEPS

    def run3():
        for b in batches[n_steps:n_steps + 3]:
            state[:5] = step(*state, b, lrs, FIELD_LR)[:5]
        torch.cuda.synchronize()

    wall_ms, busy_ms, idle, top = device_idle(run3)
    n_params = sum(v.numel() for v in fp.values())
    print(f"{label}: phase 6's step ({N_SPLATS} splats, {RES}x{RES}, 1 view) "
          f"with {hidden}, n_splats {n_splats}: {n_params} field parameters; "
          f"{step_ms:.4f} ms/step ({OPTION_STEPS} steps after "
          f"{TRAIN_WARMUP} warm-up), {rendered} splats rendered a step, "
          f"{seen} seen; losses {[round(x, 6) for x in losses.tolist()]}; "
          f"blend launches {launches}; 3 profiled steps: wall "
          f"{wall_ms:.3f} ms, GPU busy {busy_ms:.3f} ms, GPU idle share "
          f"{idle:.4f}; {smi}")
    print(f"{label}: top device events (ms over 3 steps, calls): "
          + "; ".join(f"{k} {ms:.3f} ({c})" for ms, c, k in top[:8]))
    # both kernels on a step's own inputs and an evaluation frame's
    with LoopBlends() as cap:
        state[:5] = step(*state, batches[n_steps + 3], lrs, FIELD_LR)[:5]
        frame = render_camera(make_views(1, RES)[0], state[0], state[1],
                              deform, pipe, np.ones(3, np.float32))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(frame["render"]).all()):
        raise AssertionError(f"{label}: non-finite evaluation frame")
    return launches, check_loop_blends(label, cap)


def var_grid_alone(dev, smi, xyz):
    """Phase 27's VarGridEncoder (no encoder key builds it into a field):
    forward and backward on the step's points, timed; its features on
    2,000 of them within 1e-4 of their largest value of the CPU's from
    the same seed."""
    import torch

    from splatfields_torch.models.encoders import VarGridEncoder
    enc = VarGridEncoder(generator=torch.Generator().manual_seed(0))
    cpu_feat = enc(xyz[:2000].cpu()).detach()
    enc = enc.to(dev)
    params = list(enc.parameters())

    def fwd_bwd():
        return torch.autograd.grad(enc(xyz).square().sum(), params)

    grads = fwd_bwd()
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(g).all()) for g in grads) or not any(
            float(g.abs().max()) > 0 for g in grads):
        raise AssertionError("phase 27 VarGridEncoder: bad gradients")
    err = float((enc(xyz[:2000]).detach().cpu() - cpu_feat).abs().max()
                / cpu_feat.abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"phase 27 VarGridEncoder: card against CPU "
                             f"{err}")
    ms = cuda_ms(fwd_bwd, 5)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: enc(xyz), 5)
        grid = tuple(enc.net().shape[1:])
    print(f"phase 27 VarGridEncoder alone: noise 8x4^3 -> grid {grid}, "
          f"{sum(p.numel() for p in params)} parameters; forward "
          f"{fwd_ms:.4f} ms, forward + backward {ms:.4f} ms on "
          f"{xyz.shape[0]} points; card against CPU on 2,000 points "
          f"{err:.3e} of the largest feature; {smi}")


def fused_option(dev, smi, label, hidden, pts, cols, batches):
    """Phase 28 for one field: the fused heads (bf16) in a training step
    of phase 27's configuration, held layer by layer on the step's own
    inputs (``check_layers``, TOL_LAYER), then 3 steps counting launches.
    Returns ({kernel: launches}, the largest layer gap)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops import fused_mlp as fm

    deform = DeformModel(config.HiddenConfig(
        composition_rank=0, n_frames=0, **hidden), radius=1.0, seed=0,
        device=dev)
    net = deform.net
    net.fused_pallas = "on"
    step = train_lib.make_train_step(
        net, config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01),
        config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128),
        RES, RES, 1, True, 0, 0)
    sp, st = splats.create_from_pcd(pts, cols, 0, capacity=N_SPLATS,
                                    device=dev)
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    captured = []
    fused_bwd = fm.fused_heads_bwd

    def spy(plan, emb, feat, w, b, gs, cdt):
        captured.append((plan, emb.detach(), feat.detach(), w.detach(),
                         b.detach(), [g.detach() for g in gs]))
        return fused_bwd(plan, emb, feat, w, b, gs, cdt)

    # the backward counts through its module-level name, the spy's here
    spy.launches = fused_bwd.launches
    fm.fused_heads_bwd = spy
    try:
        state = list(step(sp, st, splats.adam_init(sp), deform.params,
                          deform.opt_state, batches[0], lrs, FIELD_LR)[:5])
    finally:
        fused_bwd.launches = spy.launches
        fm.fused_heads_bwd = fused_bwd
    names = [c[0].heads[0].name for c in captured]
    if sorted(names) != ["mlp_deform", "mlp_rgb"]:
        raise AssertionError(f"phase 28 {label}: fused backward ran for "
                             f"{names}")
    gap = 0.0
    for case in captured:
        plan = case[0]
        print(f"phase 28 {label}: plan {[h.name for h in plan.heads]}, "
              f"feature width {plan.feat_dim}, embedding {plan.emb_dim}, "
              f"outputs {[h.out_dim for h in plan.heads]}, "
              f"{plan.n_rows} packed rows")
        gap = max(gap, check_layers(f"phase 28 {label}, {plan.heads[0].name}",
                                    *case)["gap"])
    torch.cuda.synchronize()
    fm.fused_heads.launches = fm.fused_heads_bwd.launches = 0
    fm.fused_dw.launches = fm.reduce_partials.launches = 0
    for b in batches[1:4]:
        *state, out = step(*state, b, lrs, FIELD_LR)
    torch.cuda.synchronize()
    launches = {"fused_heads_fwd": fm.fused_heads.launches,
                "fused_heads_bwd": fm.fused_heads_bwd.launches,
                "fused_heads_dw": fm.fused_dw.launches,
                "reduce_partials": fm.reduce_partials.launches}
    if set(launches.values()) != {6} or not bool(torch.isfinite(out.loss)):
        raise AssertionError(f"phase 28 {label}: 3 fused steps launched "
                             f"{launches}, loss {float(out.loss)}")
    print(f"phase 28 {label}: 3 fused steps (bf16 heads), launches "
          f"{launches}, loss {float(out.loss):.6f}; {smi}")
    return launches, gap


def option_clis(dev, smi):
    """Phase 30: run_owlii.sh's train and render lines with
    ``OPTION_OWLII_FLAGS`` on phase 25's scene, then run_blender.sh's
    SplatFields line with ``OPTION_BLENDER_FLAGS`` on phase 14's scene
    (init from phase 15's PLY), a ``--resume`` run and its render line.
    Returns ({kernel name: {phase: launches}}, {phase: check_loop_blends'
    errors})."""
    import glob
    import shutil
    import time

    import torch

    from splatfields_torch import render, train
    from splatfields_torch.metrics import read_results
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    here = os.path.dirname(os.path.abspath(__file__))
    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs = {}

    def counted(phase, want):
        torch.cuda.synchronize()
        got = (blend_fwd.launches, blend_bwd.launches)
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        if got != want:
            raise AssertionError(f"phase {phase}: blend launches {got}; "
                                 f"want {want}")

    # --- the Owlii lines with VarHexPlane and per-frame deltas
    base = os.path.join(here, "build", "owlii_protocol")
    out = os.path.join(base, "out_options")
    it = OPTION_OWLII_ITERS
    env = dict(OWLII_ENV, DATASET_ROOT=base, SCENE=OWLII_SCENE, OUT=out,
               ITERS=it, TIME_STEP=OPTION_OWLII_FRAMES)
    train_argv, render_argv = owlii_command_lines(env)
    run = os.path.join(out, "8views", OWLII_SCENE, "SplatFields4D")
    extra = ["--densify_from_iter", str(it + 1), "--test_iterations", "1",
             str(it)]
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with LoopBlends() as cap:
        res = train.main(train_argv + OPTION_OWLII_FLAGS + extra)
    evals = 2 * (min(25, OPTION_OWLII_FRAMES) + 5)
    counted("30 owlii", (5 * it + evals, 5 * it))
    net = res.deform.net
    if not (type(net.encoder).__name__ == "VarHexPlaneEncoder"
            and net.encoder.subs_0.net.conv_in.frame_weights.shape[0]
            == OPTION_OWLII_FRAMES):
        raise AssertionError("phase 30: the Owlii run's net is not a "
                             "per-frame VarHexPlane")
    on_card("phase 30 owlii", res.deform.params)
    psnr = dict(read_metrics(run)["test/loss_viewpoint - psnr"])
    loop_errs["30 owlii"] = check_loop_blends("phase 30 owlii", cap)
    ms_it = res.ms_per_it
    del cap, res, net
    t0 = time.time()
    render.main(render_argv + OPTION_OWLII_FLAGS)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    n_render = sum(len(glob.glob(os.path.join(run, s, f"ours_{it}",
                                              "renders", "*.png")))
                   for s in ("train", "test"))
    yaml = read_results(os.path.join(run, "test", f"ours_{it}",
                                     "results.yaml"))
    if not (n_render == (OWLII_TRAIN_CAMS + 1) * OPTION_OWLII_FRAMES
            and all(np.isfinite(v) for v in psnr.values())
            and np.isfinite(yaml["psnr"])):
        raise AssertionError(f"phase 30 owlii: {n_render} frames, test PSNR "
                             f"{psnr}, results.yaml {yaml}")
    print(f"phase 30: run_owlii.sh's train line + {OPTION_OWLII_FLAGS} "
          f"(ITERS={it}, TIME_STEP={OPTION_OWLII_FRAMES}, "
          f"{OWLII_RES}x{OWLII_RES}, 5 views), {ms_it:.3f} ms/it, test PSNR "
          f"{psnr}; its render line + the same flags, {n_render} frames in "
          f"{render_s:.3f} s, results.yaml {yaml}; blend launches "
          f"{launches['blend_fwd']['30 owlii']}, "
          f"{launches['blend_bwd']['30 owlii']}; {smi}")
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()

    # --- the SplatFields line with TriPlane, view-dependent colour, n_splats
    proto = os.path.join(here, "build", "blender_protocol")
    root = os.path.join(proto, "lego")
    pc = os.path.join(proto, "out", "3DGS", "point_cloud", "iteration_300",
                      "point_cloud.ply")
    out = os.path.join(proto, "out", "SplatFields_options")
    it = OPTION_BLENDER_ITERS
    argv = (["-s", root, "-m", out] + PROTOCOL_FIELD + OPTION_BLENDER_FLAGS
            + ["--pc_path", pc, "--test_iterations", "1", str(it)])
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with LoopBlends() as cap:
        res = train.main(argv + ["--iterations", str(it)])
    evals = 2 * (len(PROTOCOL_TEST_THETAS) + 5)
    counted("30 blender", (it + evals, it))
    net = res.deform.net
    if not (type(net.encoder).__name__ == "TriPlaneEncoder"
            and net.use_view_dep_rgb):
        raise AssertionError("phase 30: the Blender run's net lacks its "
                             "options")
    eval_psnr = dict(read_metrics(out)["test/loss_viewpoint - psnr"])
    loop_errs["30 blender"] = check_loop_blends("phase 30 blender", cap)
    ms_it = res.ms_per_it
    del cap, res, net
    resumed = train.main(argv + ["--iterations", str(it + 10), "--resume"])
    if resumed.start_iteration != it + 1:
        raise AssertionError(f"phase 30: --resume started at "
                             f"{resumed.start_iteration}")
    del resumed
    t0 = time.time()
    render.main(["-s", root, "-m", out, "--skip_train", "--iteration",
                 str(it)])
    torch.cuda.synchronize()
    render_s = time.time() - t0
    ours = os.path.join(out, "test", f"ours_{it}")
    yaml = read_results(os.path.join(ours, "results.yaml"))
    bound = png_round_trip_bound(ours)
    if not abs(yaml["psnr"] - eval_psnr[it]) <= bound:
        raise AssertionError(f"phase 30 blender: render.py PSNR "
                             f"{yaml['psnr']} vs evaluate {eval_psnr[it]}: "
                             f"beyond the PNG bound {bound}")
    print(f"phase 30: run_blender.sh's SplatFields line + "
          f"{OPTION_BLENDER_FLAGS} ({it} iterations, {RES}x{RES}), "
          f"{ms_it:.3f} ms/it, test PSNR {eval_psnr}; --resume from {it} to "
          f"{it + 10}; render CLI {len(PROTOCOL_TEST_THETAS)} test frames "
          f"in {render_s:.3f} s, results.yaml {yaml} (evaluate "
          f"{eval_psnr[it]:.4f}, PNG bound {bound:.4f}); blend launches "
          f"{launches['blend_fwd']['30 blender']}, "
          f"{launches['blend_bwd']['30 blender']}; {smi}")
    return launches, loop_errs


def subset_step(dev, pts, cols, subset):
    """Phase 31's small static step with ``n_splats``: phase 7's
    configuration rendering the splats ``subset`` on the card and on the
    CPU (the subsample's keys differ between the card's generator and the
    CPU's, so both are given the same subset)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    res = {}
    draw = train_lib._subsample_idx
    train_lib._subsample_idx = lambda gen, valid, n: torch.as_tensor(
        subset[:n], device=valid.device)
    try:
        for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
            p_, s_ = splats.create_from_pcd(pts[:2000], cols[:2000], 0,
                                            device=device)
            d_ = DeformModel(config.HiddenConfig(
                encoder_type="VarTriPlaneEncoder", composition_rank=0,
                n_frames=0), radius=1.0, seed=0, device=device)
            step = train_lib.make_train_step(
                d_.net, config.OptimizationConfig(lambda_mask=0.0,
                                                  lambda_norm=0.01),
                config.PipelineConfig(tile_size=16, tile_cap=1024,
                                      k_chunk=128), 64, 64, 1, True, 0, 0,
                n_splats=len(subset), generator=torch.Generator(device))
            res[name] = step(
                p_, s_, nonzero_adam(p_, 1), d_.params,
                nonzero_adam(d_.params, 2),
                train_batch(make_views(2, 64)[1], np.random.RandomState(1),
                            device), splats.splat_lr_tree(*SPLAT_LRS),
                FIELD_LR)
    finally:
        train_lib._subsample_idx = draw
    return res["cuda"], res["cpu"]


HEX_SEEDS = tuple(range(3))   # phase 31's study: the net's weight seeds
HEX_NOISE = 1e-6              # its relative perturbation of the attributes
HEX_DRAWS = 3


def hex_step(device, pts, cols, seed=0):
    """Phase 31's small VarHexPlane per-frame step on ``device`` from the
    net of ``seed``."""
    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    net = small_4d_net(device, seed, **SMALL_HEX)
    p_, s_ = splats.create_from_pcd(pts[:2000], cols[:2000], 0, device=device)
    fp = {k: v.detach() for k, v in net.named_parameters()}
    step = train_lib.make_train_step(
        net, config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01),
        config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128),
        64, 64, 2, True, SMALL_HEX["n_frames"], 0)
    return step(p_, s_, nonzero_adam(p_, 1), fp, nonzero_adam(fp, 2),
                owlii_batch(make_views(3, 64)[1:], 2 / 3,
                            np.random.RandomState(1), device),
                splats.splat_lr_tree(*SPLAT_LRS), FIELD_LR)


def hex_attributes(device, pts, cols, seed, dtype=None):
    """The field's attributes in phase 31's step, from the net of
    ``seed``: on ``device`` in f32, or with the net and the splats cast to
    ``dtype`` after the same f32 draws (float64 on the CPU); returned in
    f32."""
    import torch

    from splatfields_torch import train_lib
    from splatfields_torch.models import splats
    net = small_4d_net(device, seed, **SMALL_HEX)
    p_, s_ = splats.create_from_pcd(pts[:2000], cols[:2000], 0, device=device)
    default = torch.get_default_dtype()
    if dtype is not None:
        net = net.to(dtype)
        p_ = splats.tree_map(lambda a: a.to(dtype), p_)
        torch.set_default_dtype(dtype)
    try:
        with torch.no_grad():
            a = train_lib.field_attributes(
                net, p_.xyz, splats.get_scaling(p_), s_.valid, 2 / 3,
                SMALL_HEX["n_frames"])
    finally:
        torch.set_default_dtype(default)
    return {k: v.float() if v.is_floating_point() else v for k, v in a.items()
            if isinstance(v, torch.Tensor)}


def hex_render_vjp(attrs, device):
    """Phase 31's step from the field's attributes on: both views'
    renders and the loss, and its VJP -> (the renders [2, 3, 64, 64], {the
    last view's screen offset ("screen") and each float attribute:
    gradient}), in float64 on the CPU."""
    import torch

    from splatfields_torch import config, train_lib
    attrs = {k: v.detach().to(device).requires_grad_(v.is_floating_point())
             for k, v in attrs.items()}
    batch = owlii_batch(make_views(3, 64)[1:], 2 / 3,
                        np.random.RandomState(1), device)
    pipe = config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128)
    n = attrs["means3d"].shape[0]
    offsets = [torch.zeros(n, 2, device=device, requires_grad=True)
               for _ in range(2)]
    outs = [train_lib.render_view(
        attrs, {k: batch[k][v] for k in ("viewmatrix", "projmatrix",
                                         "campos", "tanfovx", "tanfovy")},
        batch["bg"], 64, 64, 0, pipe, offsets[v]) for v in range(2)]
    loss, _ = train_lib.compute_losses(
        outs, batch, attrs, config.OptimizationConfig(lambda_mask=0.0,
                                                      lambda_norm=0.01),
        attrs["valid"])
    names = [k for k, v in attrs.items() if v.requires_grad]
    grads = torch.autograd.grad(loss, [offsets[-1]] + [attrs[k]
                                                       for k in names],
                                allow_unused=True)
    return (torch.stack([o.color for o in outs]).detach().double().cpu(),
            {k: g.double().cpu() for k, g in zip(["screen"] + names, grads)
             if g is not None})


def hex_screen_grad(attrs, device):
    """Phase 31's step from the field's attributes on -> the last view's
    screen-offset gradient, in float64 on the CPU."""
    return hex_render_vjp(attrs, device)[1]["screen"]


def hex_equal_attributes(dev, pts, cols, seed=0):
    """Phase 31's render and its VJP on equal attributes: the card's own
    (the net of ``seed``) rendered on the card (kernels) and on the CPU
    (plain blends). The renders within TOL's colour bound, each gradient
    within 1e-4 of its max (phase 7's screen-gradient bound); the
    weights' margin (``hex_study``) cannot move this check. -> (render
    err, {name: gradient err over its max})."""
    attrs = hex_attributes(dev, pts, cols, seed)
    (card, g_card), (cpu, g_cpu) = (hex_render_vjp(attrs, dev),
                                    hex_render_vjp(attrs, "cpu"))
    render_err = float((card - cpu).abs().max())
    errs = {k: float((g_card[k] - g).abs().max() / g.abs().max().clamp_min(
        1e-30)) for k, g in g_cpu.items()}
    print(f"phase 31: the card's attributes (seed {seed}) rendered on the "
          f"card and on the CPU: render max abs err {render_err:.3e} (bound "
          f"{TOL['color']}); the VJP, largest difference over its max "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + " (bound 1e-4)")
    if not render_err <= TOL["color"]:
        raise AssertionError("phase 31: the render on equal attributes")
    if set(errs) != set(g_card) or not max(errs.values()) <= 1e-4:
        raise AssertionError("phase 31: the VJP on equal attributes")
    return render_err, errs


def hex_study(dev, pts, cols):
    """Phase 31's study of how far the step's screen gradient moves, over
    its max, at every ``HEX_SEEDS`` net seed: the card against the CPU
    (each its own attributes, render and backward), the CPU on the
    float64 attributes against the CPU, and the CPU on its own attributes
    perturbed by ``HEX_NOISE`` relative noise (``HEX_DRAWS`` draws, the
    largest) against the CPU. -> {seed: (card, f64, noise)}."""
    import torch
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    out = {}
    for s in HEX_SEEDS:
        a_cpu = hex_attributes(cpu, pts, cols, s)
        ref = hex_screen_grad(a_cpu, cpu)
        scale = ref.abs().max()

        def gap(g):
            return float((g - ref).abs().max() / scale)

        noisy = []
        for _ in range(HEX_DRAWS):
            pert = {k: v * (1 + HEX_NOISE * (2 * torch.rand(
                v.shape, generator=gen) - 1)) if v.is_floating_point()
                else v for k, v in a_cpu.items()}
            noisy.append(gap(hex_screen_grad(pert, cpu)))
        out[s] = (gap(hex_screen_grad(hex_attributes(dev, pts, cols, s),
                                      dev)),
                  gap(hex_screen_grad(hex_attributes(
                      cpu, pts, cols, s, torch.float64), cpu)),
                  max(noisy))
    return out


def option_phases(dev, smi):
    """Phases 27-31: the train CLI's field options. Returns ({kernel name:
    {phase: launches}}, {phase: check_loop_blends' errors}, {fused kernel
    name: {phase: launches}}, {phase: largest layer gap})."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats

    import time
    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs, fused_launches, fused_gaps = {}, {}, {}
    t0 = [time.time()]

    def took(phase):
        torch.cuda.synchronize()
        print(f"phase {phase} took {time.time() - t0[0]:.1f} s")
        t0[0] = time.time()

    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (N_SPLATS, 3)).astype(np.float32)
    cols = rng.rand(N_SPLATS, 3).astype(np.float32)
    batches = training_batches(dev)

    # --- 27. static field steps, one option at a time ----------------------
    for label, hidden, n_splats in OPTION_FIELDS:
        phase = f"27 {label}"
        got, loop_errs[phase] = option_step(
            dev, smi, f"phase {phase}", hidden, n_splats, pts, cols, batches)
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        torch.cuda.empty_cache()
    var_grid_alone(dev, smi, torch.as_tensor(pts, device=dev))
    took(27)

    # --- 28. the fused heads on the new plans ---------------------------------
    for label, hidden, _ in FUSED_OPTIONS:
        phase = f"28 {label}"
        got, fused_gaps[phase] = fused_option(dev, smi, label, hidden, pts,
                                              cols, batches)
        for k, n in got.items():
            fused_launches.setdefault(k, {})[phase] = n
        torch.cuda.empty_cache()
    took(28)

    # --- 29. 4-D steps at phase 23's workload, 1 view ----------------------------
    for label, hidden in HEX_OPTIONS:
        phase = f"29 {label}"
        got, loop_errs[phase], _ = owlii_step(
            dev, smi, 1, pts, cols, hidden=hidden, label=f"phase {phase}")
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        torch.cuda.empty_cache()
    took(29)

    # --- 30. the CLIs with the new flags ----------------------------------------
    got, errs = option_clis(dev, smi)
    for k in launches:
        launches[k].update(got[k])
    loop_errs.update(errs)
    took(30)

    # --- 31. card against CPU ------------------------------------------------------
    proto = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "blender_protocol")
    card_vs_cpu("phase 31 " + " ".join(OPTION_SMALL_FLAGS[:5]),
                ["-s", os.path.join(proto, "small", "lego"),
                 "--white_background", "--eval", "--n_views", "4",
                 "--num_pts", "2000", "--load_time_step", "0",
                 "--composition_rank", "0"] + OPTION_SMALL_FLAGS,
                os.path.join(proto, "small_out", "options"), dev)
    subset = np.random.RandomState(3).permutation(2000)[:1500]
    print("phase 31: a small static step with n_splats 1,500 of 2,000 "
          "(phase 7's configuration, the same subset on both), card "
          "against CPU:")
    check_small_step(*subset_step(dev, pts, cols, subset))
    res = {name: hex_step(device, pts, cols)
           for name, device in (("cuda", dev), ("cpu", torch.device("cpu")))}
    print("phase 31: a small 4-D step (chip_smoke.SMALL_HEX: VarHexPlane "
          "with per-frame deltas, 2,000 splats, 64x64, 2 views, fid 2/3), "
          "card against CPU:")
    check_small_step(res["cuda"], res["cpu"])
    study = hex_study(dev, pts, cols)
    print("phase 31 study, the small 4-D step's screen gradient, largest "
          "difference over its max, by net seed (card - CPU; CPU on the "
          f"f64 attributes - CPU; CPU on its attributes x (1 +- {HEX_NOISE}"
          f") - CPU, worst of {HEX_DRAWS} draws): "
          + "; ".join(f"seed {s}: {a:.3e}, {b:.3e}, {c:.3e}"
                      for s, (a, b, c) in study.items()))
    hex_equal_attributes(dev, pts, cols)
    took(31)
    return launches, loop_errs, fused_launches, fused_gaps


# --- phases 32-35: the Colmap and nerfies datasets, --profile, --watchdog_min
# phase 32: run_dtu.sh on a COLMAP scan; ITERS and PC_ITER cut as phase 20's;
# frames of 800x600, not a DTU capture's 1600x1200: at -r 2 of those the
# render CLI's host metrics took 1.7 s a frame on an H100 machine's host,
# 58 s a render line
COLMAP_SIZE = (800, 600)
COLMAP_GT_SPLATS, COLMAP_POINTS = 30_000, 20_000
# phase 33: run_owlii.sh's train line on a nerfies capture (ITERS cut; the
# reader's default 300,000-point cap keeps the DUSt3R cloud whole)
NERFIES_SIZE, NERFIES_TIMES = (480, 270), 10
NERFIES_GT_SPLATS, NERFIES_POINTS = 30_000, 100_000
NERFIES_ITERS = 8
NERFIES_PRED = 650      # 14 keyframes of the rig, 50 poses a segment
GEO_MESH_RES = 64
# phase 34: a small Colmap and a small nerfies run, card against CPU
NERFIES_SMALL_ARGV = ("--white_background --eval --load_time_step 2 "
                      "--flow_model offset --all_training --num_views 2 "
                      "--encoder_type VarTriPlaneEncoder "
                      "--composition_rank 40").split()
# phase 35: phase 15's line with --profile --watchdog_min 30
PROFILE_ITERS = 31


def dataset_phases(dev, smi):
    """Phases 32-35: the Colmap and nerfies datasets through the CLIs,
    card against CPU, ``--profile`` and ``--watchdog_min``. Returns
    ({kernel name: {phase: launches}}, {phase: check_loop_blends' errors},
    {phase: check_partial_tiles' errors})."""
    import shutil

    import torch

    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "build", "dataset_protocol")
    shutil.rmtree(base, ignore_errors=True)
    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs, partial_errs = {}, {}

    def counted(phase, want_fwd, want_bwd):
        torch.cuda.synchronize()
        got = (blend_fwd.launches, blend_bwd.launches)
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        if got != (want_fwd, want_bwd):
            raise AssertionError(f"phase {phase}: blend launches {got}; want "
                                 f"{(want_fwd, want_bwd)}")

    colmap_protocol(dev, smi, base, counted, loop_errs, partial_errs)
    nerfies_protocol(dev, smi, base, counted, loop_errs, partial_errs)

    # --- 34. card against CPU: a small Colmap and a small nerfies run -------
    # phase 21's size: at 64x48 (-r 2: 32x24) most splats are below a
    # pixel, their scale gradients at the level of summation noise, and
    # Adam's first steps (m / sqrt(v) ~ +-1) drift the losses past 1e-5
    small = write_colmap_scene(os.path.join(base, "colmap_small"), 160, 120,
                               torch.device("cpu"), n_splats=3000,
                               n_points=2000)
    card_vs_cpu("phase 34 Colmap 3DGS (run_dtu.sh's flags, 160x120, -r 2)",
                ["-s", small] + DTU_3DGS,
                os.path.join(base, "small_out", "colmap"), dev)
    small_base = os.path.join(base, "nerfies_small")
    nerfies = write_nerfies_scene(small_base, 64, 36, 2, torch.device("cpu"),
                                  n_splats=2000, n_points=2000)
    resumed_card_vs_cpu(
        "phase 34 nerfies (run_owlii.sh's flags, 64x36, 2 times, rank 40, "
        "2 views)", ["-s", nerfies] + NERFIES_SMALL_ARGV, small_base, dev)

    profile_phase(dev, smi, counted)
    shutil.rmtree(base, ignore_errors=True)
    return launches, loop_errs, partial_errs


def colmap_protocol(dev, smi, base, counted, loop_errs, partial_errs):
    """Phase 32: ``run_dtu.sh``'s four lines on ``write_colmap_scene``,
    then ``extract_geo`` on the SplatFields3D run."""
    import time

    import torch

    from splatfields_torch import extract_geo, render, train
    from splatfields_torch.data.colmap_io import read_points3d_binary
    from splatfields_torch.data.ply import fetch_pointcloud
    from splatfields_torch.data.registry import sniff_scene_type
    from splatfields_torch.metrics import read_results
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.utils.system import search_for_max_iteration

    t0 = time.time()
    scan = write_colmap_scene(base, *COLMAP_SIZE, dev,
                              n_splats=COLMAP_GT_SPLATS,
                              n_points=COLMAP_POINTS)
    torch.cuda.synchronize()
    kind = sniff_scene_type(scan)
    print(f"phase 32: COLMAP scan ({kind}), {COLMAP_VIEWS} views of "
          f"{COLMAP_SIZE[0]}x{COLMAP_SIZE[1]} RGBA, {COLMAP_POINTS} points "
          f"with tracks, {COLMAP_GT_SPLATS} ground-truth splats, written in "
          f"{time.time() - t0:.2f} s")
    if kind != "Colmap":
        raise AssertionError(f"phase 32: the scan sniffs as {kind}")
    out = os.path.join(base, "dtu")
    env = dict(DATASET_ROOT=base, SCENE=COLMAP_SCAN, OUT=out,
               PC_ITER=DTU_ITERS)
    lines = (script_command_lines("run_dtu.sh", dict(env, ITERS=DTU_ITERS))[:2]
             + script_command_lines("run_dtu.sh",
                                    dict(env, ITERS=DTU_FIELD_ITERS))[2:])
    weights = write_lpips_weights(os.path.join(base, "lpips_vgg.npz"))
    xyz3d = read_points3d_binary(os.path.join(scan, "sparse", "0",
                                              "points3D.bin"))[0]
    w, h = COLMAP_SIZE[0] // 2, COLMAP_SIZE[1] // 2
    for (_, argv), (_, render_argv) in (lines[0:2], lines[2:4]):
        name = os.path.basename(argv[argv.index("-m") + 1])
        iters = int(argv[argv.index("--iterations") + 1])
        phase = f"32 {name}"
        blend_fwd.launches = blend_bwd.launches = 0
        with Timed("Colmap") as timed, LoopBlends() as cap:
            res = train.main(argv)
        counted(phase, iters, iters)
        on_card(f"phase {phase}",
                {**dict(vars(res.params)), **dict(vars(res.stats))})
        run = argv[argv.index("-m") + 1]
        init, _, _ = fetch_pointcloud(os.path.join(run, "input.ply"))
        if "--pc_path" in argv:
            pc = fetch_pointcloud(argv[argv.index("--pc_path") + 1])[0]
            want = pc[np.all(np.abs(pc) < 1, axis=1)]
        else:
            want = xyz3d.astype(np.float32)
        if not np.array_equal(init, want):
            raise AssertionError(f"phase {phase}: the splats do not start "
                                 "from the points the line names")
        m = read_metrics(run)
        mask_loss = [v for _, v in m.get("train_loss_patches/mask", [])]
        if not (mask_loss and np.isfinite(mask_loss).all()):
            raise AssertionError(f"phase {phase}: no mask loss {m.keys()}")
        print(f"phase {phase}: {iters} iterations at {w}x{h} (-r 2 of "
              f"{COLMAP_SIZE[0]}x{COLMAP_SIZE[1]}), {res.ms_per_it:.3f} "
              f"ms/it, step {res.step_ms:.3f} ms mean, init {len(init)} "
              f"points, {int(res.stats.valid.sum())} splats at the end, "
              f"dup_factor growth {res.dup_growth}, mask loss (every 10th "
              f"iteration) {mask_loss[0]:.5f} -> {mask_loss[-1]:.5f}; reader "
              f"{timed.seconds('reader'):.3f} s for {COLMAP_VIEWS} views; "
              f"{smi}")
        del res
        loop_errs[phase] = check_loop_blends(f"phase {phase}", cap)
        partial_errs[phase] = check_partial_tiles(f"phase {phase}", cap, w, h)
        del cap
        blend_fwd.launches = 0
        t0 = time.time()
        with Timed("Colmap") as timed:
            results = render.main(render_argv + ["--lpips_weights", weights])
        torch.cuda.synchronize()
        render_s = time.time() - t0
        n_frames = 3 + 25   # the train views and the pixelNeRF test views
        launches_render = blend_fwd.launches
        if launches_render != n_frames:
            raise AssertionError(f"phase {phase}: render launched "
                                 f"{launches_render} blends")
        for split in ("train", "test"):
            got = read_results(os.path.join(run, split, f"ours_{iters}",
                                            "results.yaml"))
            if not (results[split]["psnr"] == got["psnr"]
                    and np.isfinite([got["psnr"], got["lpips"]]).all()):
                raise AssertionError(f"phase {phase}: render.py {split} "
                                     f"{got}")
        print(f"phase {phase}: render CLI with --lpips_weights, "
              f"{n_frames} frames in {render_s:.3f} s (scene load "
              f"{timed.seconds('scene'):.3f} s, metrics "
              f"{timed.seconds('metrics'):.3f} s); test {results['test']}; "
              f"{smi}")

    run = os.path.join(out, COLMAP_SCAN, "3views", "SplatFields3D")
    t0 = time.time()
    report = extract_geo.main(["-m", run, "--mesh_resolution",
                               str(GEO_MESH_RES)])
    torch.cuda.synchronize()
    it = search_for_max_iteration(os.path.join(run, "point_cloud"))
    verts, faces = mesh_counts(os.path.join(run, f"mesh_iteration_{it}.ply"))
    if not (len(report) == 4 and verts > 0 and faces > 0):
        raise AssertionError(f"phase 32: extract_geo {report}, mesh "
                             f"{verts}, {faces}")
    print(f"phase 32: extract_geo on SplatFields3D, {time.time() - t0:.3f} "
          f"s, MoransI {report}, mesh {GEO_MESH_RES}^3 -> {verts} vertices, "
          f"{faces} faces; {smi}")


def nerfies_protocol(dev, smi, base, counted, loop_errs, partial_errs):
    """Phase 33: ``run_owlii.sh``'s SplatFields4D train line on
    ``write_nerfies_scene``, the render CLI with ``--render_pred`` (the
    spline's frames) and the test set, ``extract_geo`` at fid 0."""
    import glob
    import time

    import torch

    from splatfields_torch import extract_geo, render, train
    from splatfields_torch.data.registry import sniff_scene_type
    from splatfields_torch.metrics import read_results
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.utils.system import search_for_max_iteration

    t0 = time.time()
    scene = write_nerfies_scene(base, *NERFIES_SIZE, NERFIES_TIMES, dev,
                                n_splats=NERFIES_GT_SPLATS,
                                n_points=NERFIES_POINTS)
    torch.cuda.synchronize()
    kind = sniff_scene_type(scene)
    print(f"phase 33: nerfies capture ({kind}, branch {NERFIES_BRANCH}), "
          f"{NERFIES_CAMS} rig cameras x {NERFIES_TIMES} times at "
          f"{NERFIES_SIZE[0]}x{NERFIES_SIZE[1]}, {NERFIES_POINTS} DUSt3R "
          f"points, {NERFIES_GT_SPLATS} moving ground-truth splats, written "
          f"in {time.time() - t0:.2f} s")
    if kind != "nerfies":
        raise AssertionError(f"phase 33: the capture sniffs as {kind}")
    out = os.path.join(base, "nerfies")
    train_argv, render_argv = owlii_command_lines(dict(
        DATASET_ROOT=os.path.dirname(scene), SCENE=NERFIES_SCENE, OUT=out,
        ITERS=NERFIES_ITERS, TIME_STEP=NERFIES_TIMES))
    run = os.path.join(out, "8views", NERFIES_SCENE, "SplatFields4D")
    extra = ["--test_iterations", "1", str(NERFIES_ITERS)]
    n_test = NERFIES_TIMES   # rig camera 12 at every time
    blend_fwd.launches = blend_bwd.launches = 0
    with Timed("nerfies") as timed, LoopBlends() as cap:
        res = train.main(train_argv + extra)
    counted("33", 5 * NERFIES_ITERS + 2 * (min(25, n_test) + 5),
            5 * NERFIES_ITERS)
    on_card("phase 33", {**dict(vars(res.params)), **dict(vars(res.stats)),
                         **res.deform.params})
    if not (res.deform.n_frames == NERFIES_TIMES
            and int(res.stats.valid.sum()) == NERFIES_POINTS):
        raise AssertionError(f"phase 33: {res.deform.n_frames} frames, "
                             f"{int(res.stats.valid.sum())} splats")
    psnr = dict(read_metrics(run)["test/loss_viewpoint - psnr"])
    if not psnr[NERFIES_ITERS] > psnr[1]:
        raise AssertionError(f"phase 33: test PSNR {psnr}")
    print(f"phase 33: run_owlii.sh's train line (ITERS={NERFIES_ITERS}, "
          f"TIME_STEP={NERFIES_TIMES}, {' '.join(extra)}), "
          f"{res.ms_per_it:.3f} ms/it, step {res.step_ms:.3f} ms mean "
          f"({NERFIES_SIZE[0]}x{NERFIES_SIZE[1]}, 5 views, rank 40); test "
          f"PSNR {psnr[1]:.3f} at 1 -> {psnr[NERFIES_ITERS]:.3f}; dup_factor "
          f"growth {res.dup_growth}; reader {timed.seconds('reader'):.3f} s "
          f"for {NERFIES_CAMS * NERFIES_TIMES} frames; {smi}")
    del res
    loop_errs["33"] = check_loop_blends("phase 33", cap)
    partial_errs["33"] = check_partial_tiles("phase 33", cap, *NERFIES_SIZE)
    del cap
    torch.cuda.empty_cache()
    blend_fwd.launches = 0
    t0 = time.time()
    with Timed("nerfies") as timed:
        render.main(render_argv + ["--render_pred", "--skip_train"])
    torch.cuda.synchronize()
    render_s = time.time() - t0
    it = search_for_max_iteration(os.path.join(run, "point_cloud"))
    n_pred = len(glob.glob(os.path.join(run, "pred", f"ours_{it}", "renders",
                                        "*.png")))
    yaml = read_results(os.path.join(run, "test", f"ours_{it}",
                                     "results.yaml"))
    if not (n_pred == NERFIES_PRED and blend_fwd.launches == n_pred + n_test
            and np.isfinite(yaml["psnr"])):
        raise AssertionError(f"phase 33: render CLI {n_pred} pred frames, "
                             f"{blend_fwd.launches} blends, {yaml}")
    print(f"phase 33: render CLI --render_pred --skip_train: {n_pred} "
          f"spline frames and {n_test} test frames in {render_s:.3f} s "
          f"({(n_pred + n_test) / render_s:.2f} frames/s; scene load "
          f"{timed.seconds('scene'):.3f} s, metrics "
          f"{timed.seconds('metrics'):.3f} s); test results.yaml {yaml}; "
          f"{smi}")
    t0 = time.time()
    report = extract_geo.main(["-m", run, "--mesh_resolution",
                               str(GEO_MESH_RES)])
    torch.cuda.synchronize()
    verts, faces = mesh_counts(os.path.join(run, f"mesh_iteration_{it}.ply"))
    if not (len(report) == 4 and verts > 0 and faces > 0):
        raise AssertionError(f"phase 33: extract_geo {report}, mesh "
                             f"{verts}, {faces}")
    print(f"phase 33: extract_geo at fid 0, {time.time() - t0:.3f} s, "
          f"MoransI {report}, mesh {GEO_MESH_RES}^3 -> {verts} vertices, "
          f"{faces} faces; {smi}")


def profile_phase(dev, smi, counted):
    """Phase 35: phase 15's command line on phase 14's scene for
    ``PROFILE_ITERS`` iterations with ``--profile --watchdog_min 30``: the
    trace of iterations 21-30 names both blend kernels, ten launches each;
    the watchdog's thread ends with the run."""
    import threading
    import time

    from splatfields_torch import train
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "blender_protocol", "lego")
    out = os.path.join(here, "build", "dataset_protocol", "profiled")
    blend_fwd.launches = blend_bwd.launches = 0
    t0 = time.time()
    res = train.main(["-s", root, "-m", out] + PROTOCOL_3DGS
                     + ["--iterations", str(PROFILE_ITERS), "--profile",
                        "--watchdog_min", "30", "--test_iterations", "-1"])
    run_s = time.time() - t0
    counted("35", PROFILE_ITERS, PROFILE_ITERS)
    alive = [t for t in threading.enumerate() if t.name == "StallWatchdog"]
    if alive:
        raise AssertionError(f"phase 35: the watchdog outlived the run "
                             f"{alive}")
    path = os.path.join(out, "trace", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel"
                      and k in e.get("name", ""))
               for k in ("blend_fwd_kernel", "blend_bwd_kernel")}
    n_kernel = sum(1 for e in events if e.get("cat") == "kernel")
    if kernels != {"blend_fwd_kernel": 10, "blend_bwd_kernel": 10}:
        raise AssertionError(f"phase 35: the trace's blend kernels "
                             f"{kernels}")
    print(f"phase 35: run_blender.sh's 3DGS line, {PROFILE_ITERS} "
          f"iterations with --profile --watchdog_min 30 in {run_s:.3f} s "
          f"({res.ms_per_it:.3f} ms/it, the trace's iterations included); "
          f"trace {os.path.getsize(path)} bytes, {len(events)} events, "
          f"{n_kernel} kernels, of them {kernels}; watchdog thread stopped; "
          f"{smi}")


# phase 36: the host libraries (built with g++ in phase 1, beside nvcc) and
# the native carver at 256^3 over phase 14's 100 masks
NATIVE_LIBS = ("hullcarve", "jpeg", "gif")
CARVE_RES = 256
CARVE_NUMPY_MASKS = 5        # of them, carved by both routes and compared
CARVE_TIE_BAND = 1e-3        # tests/test_native.py's band of rounding ties
# phase 37: a COLMAP capture of JPEG frames (phase 32's size and counts)
JPEG_QUALITY = 90
# phase 39: every ResField zoo member, card against CPU: a 64-wide layer,
# capacity 10 (lora_3's grid is capacity^3), rank 8, 4,096 points
ZOO_IN, ZOO_OUT, ZOO_CAP, ZOO_RANK, ZOO_N, ZOO_FRAME = 64, 64, 10, 8, 4096, 7
ZOO_FUSES = ("add", "mul", "none")
ZOO_VM_MODES = ("lookup", "interpolation", "interpolation_siren")
# every (compression, mode, fuse_mode, options) the JAX layer accepts;
# tests/test_torch_resfield_zoo.py holds each against JAX
ZOO_CASES = (
    [("vm", m, f, {}) for m in ZOO_VM_MODES for f in ZOO_FUSES]
    + [("vm", "lookup", f, {"chunk_size": None, "chunk_strategy": st})
       for st in ("shared", "delta", "both") for f in ZOO_FUSES]
    + [("vm_cum", m, f, {}) for m in ZOO_VM_MODES for f in ZOO_FUSES]
    + [(c, "lookup", f, {}) for c in ("vm_cum_mat", "vm_noweight",
                                      "vm_attention", "mm_tensor", "none",
                                      "cp", "tucker") for f in ZOO_FUSES]
    # loe ignores the fuse mode and refuses lookup; the rest ignore both
    + [("loe", m, "add", {}) for m in ("interpolation", "interpolation_siren")]
    + [(c, "lookup", "add", {}) for c in ("none_cum", "resnet", "lora_3",
                                         "lora_ngp")])
TOL_ZOO = 1e-5   # card vs CPU, of the largest value of each tree


def zoo_layer(case, capacity, in_f, out_f, rank, seed=0):
    """A ``ResFieldLinear`` of ``case`` on the CPU, every parameter drawn
    N(0, 0.3) from ``seed`` (a SIREN's U(-1, 1) / fan_in). A chunked case's
    ``chunk_size`` None means half the capacity."""
    import torch

    from splatfields_torch.models.resfields import ResFieldLinear
    c, mode, fuse, kw = case
    if "chunk_size" in kw:
        kw = dict(kw, chunk_size=kw["chunk_size"] or capacity // 2)
    gen = torch.Generator().manual_seed(seed)
    layer = ResFieldLinear(in_f, out_f, rank, capacity, mode, c, fuse, **kw,
                           generator=gen)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.startswith("weights_t_siren"):
                fan_in = p.shape[-1] if p.ndim == 2 else 128
                p.uniform_(-1.0 / fan_in, 1.0 / fan_in, generator=gen)
            else:
                p.normal_(0.0, 0.3, generator=gen)
    return layer


def zoo_inputs(case, n, in_f, frame, seed=0):
    """(x, keyword inputs) of ``case``'s way of reading time on the CPU:
    ``frame_id`` for a lookup, ``input_time`` [n, 1] for the interpolation
    modes, ``coordinates`` [n, 3] for the lora members."""
    import torch
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(n, in_f, generator=gen)
    c, mode = case[:2]
    if c.startswith("lora"):
        return x, {"coordinates": torch.rand(n, 3, generator=gen) * 2 - 1}
    if mode == "lookup":
        return x, {"frame_id": frame}
    return x, {"input_time": torch.rand(n, 1, generator=gen) * 2.5 - 1.25}


class VideoLog:
    """From ``__enter__`` on, every ``gif.write`` of the render CLI is
    recorded (the file's bytes, the frames it was handed, which are the
    PNGs' pixels, and its seconds) with the seconds of the ``render.main``
    call that made it, for ``check_videos`` (phase 38) to read after the
    phases have cleared their directories."""

    def __enter__(self):
        import time

        from splatfields_torch import render
        from splatfields_torch.data import gif
        self.videos, self.lines = [], []
        self.saved = (gif.write, render.main)
        here = os.path.dirname(os.path.abspath(__file__))

        def write(path, frames, *a, **k):
            t0 = time.time()
            self.saved[0](path, frames, *a, **k)
            seconds = time.time() - t0
            with open(path, "rb") as f:
                data = f.read()
            self.videos.append(dict(path=os.path.relpath(path, here),
                                    data=data, frames=frames,
                                    seconds=seconds, line=len(self.lines)))

        def main(*a, **k):
            t0 = time.time()
            try:
                return self.saved[1](*a, **k)
            finally:
                self.lines.append(time.time() - t0)

        gif.write, render.main = write, main
        return self

    def __exit__(self, *exc):
        from splatfields_torch import render
        from splatfields_torch.data import gif
        gif.write, render.main = self.saved
        return False


def check_videos(log, smi):
    """Phase 38: every ``video.gif`` the render CLI wrote: PIL's frame
    count, 50 ms a frame, ``loop`` 0, each frame within
    ``fixed_palette_mae`` of its PNG, and its seconds at most 10% of its
    render line's. Returns the worst share."""
    from splatfields_torch.data import gif
    if not log.videos:
        raise AssertionError("phase 38: the render CLI wrote no video.gif")
    worst_share = 0.0
    for v in log.videos:
        frames, delays, loop = gif.decode(v["data"], v["path"])
        src = np.stack(v["frames"])
        if not (frames.shape == src.shape and (delays == 50).all()
                and loop == 0):
            raise AssertionError(f"phase 38: {v['path']}: {frames.shape} "
                                 f"against {src.shape}, delays "
                                 f"{set(delays.tolist())}, loop {loop}")
        errs = np.abs(frames.astype(np.int64) - src).mean(axis=(1, 2, 3))
        bounds = np.array([fixed_palette_mae(f) for f in src])
        if (errs > bounds).any():
            i = int(np.argmax(errs - bounds))
            raise AssertionError(f"phase 38: {v['path']} frame {i}: error "
                                 f"{errs[i]} over the fixed palette's "
                                 f"{bounds[i]}")
        line_s = log.lines[v["line"]]
        share = v["seconds"] / line_s
        worst_share = max(worst_share, share)
        print(f"phase 38: {v['path']}: {len(src)} frames of "
              f"{src.shape[2]}x{src.shape[1]}, {len(v['data'])} bytes, "
              f"written in {v['seconds']:.3f} s of the render line's "
              f"{line_s:.3f} s (share {share:.4f}); mean abs error a frame "
              f"{errs.mean():.4f} (worst {errs.max():.4f}, its fixed-palette "
              f"bound {bounds[int(np.argmax(errs))]:.4f}); {smi}")
        if share > 0.10:
            raise AssertionError(f"phase 38: {v['path']}: the video took "
                                 f"{share:.3f} of its render line")
    return worst_share


def progressive_phase(dev, smi, scan, twin, launches):
    """Phase 45: phase 37's capture as progressive JPEG. ``twin`` holds the
    scan again, each frame the progressive file (``JPEG_SIMPLE_PROGRESSION``,
    10 scans) of its baseline file's quantized coefficients: each decodes
    bit for bit to its baseline twin, both timed in turns; then
    ``run_dtu.sh``'s 3DGS line through ``train.main`` on the twin, its
    blend launches counted into ``launches`` and the loop's blends held
    against their plain versions. Returns ({phase: check_loop_blends'
    errors}, {phase: check_partial_tiles' errors})."""
    import glob
    import time

    import torch

    from splatfields_torch import train
    from splatfields_torch.data import jpeg
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    t_phase = time.time()
    frames = sorted(glob.glob(os.path.join(scan, "images", "*.jpg")))
    twins = sorted(glob.glob(os.path.join(twin, COLMAP_SCAN, "images",
                                          "*.jpg")))
    if [os.path.basename(p) for p in twins] != [os.path.basename(p)
                                                for p in frames]:
        raise AssertionError(f"phase 45: {len(twins)} progressive frames "
                             f"for {len(frames)} baseline ones")
    seconds = {"baseline": 0.0, "progressive": 0.0}
    sizes = {"baseline": 0, "progressive": 0}
    for a, b in zip(frames, twins):
        pix = {}
        for kind, path in (("baseline", a), ("progressive", b)):
            with open(path, "rb") as f:
                data = f.read()
            sof = b"\xff\xc2" if kind == "progressive" else b"\xff\xc0"
            if sof not in data[:data.index(b"\xff\xda")]:
                raise AssertionError(f"phase 45: {path} is not {kind}")
            t0 = time.perf_counter()
            pix[kind] = jpeg.decode(data, path)
            seconds[kind] += time.perf_counter() - t0
            sizes[kind] += len(data)
        if not np.array_equal(pix["baseline"], pix["progressive"]):
            raise AssertionError(f"phase 45: {b} decodes to other pixels "
                                 "than its baseline twin")
    mpix = len(frames) * COLMAP_SIZE[0] * COLMAP_SIZE[1] / 1e6
    rate = {k: s * 1e3 / mpix for k, s in seconds.items()}
    print(f"phase 45: {len(frames)} progressive frames ({COLMAP_SIZE[0]}x"
          f"{COLMAP_SIZE[1]}, 10 scans, {sizes['progressive']} bytes against "
          f"{sizes['baseline']}) decode bit for bit to their baseline twins;"
          f" decode baseline {rate['baseline']:.3f}, progressive "
          f"{rate['progressive']:.3f} ms a megapixel ("
          f"{rate['progressive'] / rate['baseline']:.3f}x), in turns; "
          f"{os.cpu_count()} host cores; {smi}")
    env = dict(DATASET_ROOT=twin, SCENE=COLMAP_SCAN,
               OUT=os.path.join(twin, "dtu"), PC_ITER=DTU_ITERS)
    _, argv = script_command_lines("run_dtu.sh",
                                   dict(env, ITERS=DTU_ITERS))[0]
    name = os.path.basename(argv[argv.index("-m") + 1])
    iters = int(argv[argv.index("--iterations") + 1])
    phase = f"45 {name}"
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    with Timed("Colmap") as timed, LoopBlends() as cap:
        res = train.main(argv)
    torch.cuda.synchronize()
    got = (blend_fwd.launches, blend_bwd.launches)
    launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
    if got != (iters, iters) or not np.isfinite(res.ms_per_it):
        raise AssertionError(f"phase {phase}: blend launches {got}, "
                             f"{res.ms_per_it} ms/it")
    on_card(f"phase {phase}",
            {**dict(vars(res.params)), **dict(vars(res.stats))})
    w, h = COLMAP_SIZE[0] // 2, COLMAP_SIZE[1] // 2
    print(f"phase {phase}: {iters} iterations on the progressive capture at "
          f"{w}x{h} (-r 2), {res.ms_per_it:.3f} ms/it, step "
          f"{res.step_ms:.3f} ms mean, {int(res.stats.valid.sum())} splats "
          f"at the end; reader {timed.seconds('reader'):.3f} s for "
          f"{COLMAP_VIEWS} progressive views; blend launches {got}; {smi}")
    del res
    loop_errs = {phase: check_loop_blends(f"phase {phase}", cap)}
    partial_errs = {phase: check_partial_tiles(f"phase {phase}", cap, w, h)}
    del cap
    print(f"phase 45: {time.time() - t_phase:.1f} s (the twins' encoding "
          f"is in phase 37's writing)")
    return loop_errs, partial_errs


def host_tail_phases(dev, smi, video_log):
    """Phases 36-39 and 45: the native carver against the NumPy route, a
    COLMAP capture of JPEG frames through the CLIs (and, before it is
    deleted, phase 45 on its progressive twin), every ``video.gif`` of the
    run, every ResField zoo member card against CPU. Returns
    ({kernel name: {phase: launches}}, the segment sums' max abs errors on
    ``lora_ngp``'s inputs, phase 45's {phase: check_loop_blends' errors}
    and {phase: check_partial_tiles' errors})."""
    import glob
    import shutil
    import time

    import torch

    from splatfields_torch import native, render, train
    from splatfields_torch.data import images
    from splatfields_torch.data.point_init import _grid_points, \
        mask_filter_points
    from splatfields_torch.data.readers import blender
    from splatfields_torch.data.registry import sniff_scene_type
    from splatfields_torch.metrics import read_results
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    here = os.path.dirname(os.path.abspath(__file__))
    launches = {"blend_fwd": {}, "blend_bwd": {}, "segsum": {}}

    # --- 36. the native library and the carver ------------------------------
    for name in NATIVE_LIBS:
        native.library(name, {})   # built from the checkout in phase 1
        print(f"phase 36: native {name}: {native.lib_path(name).name}, "
              f"g++ {native.BUILD_SECONDS.get(name, 0.0):.2f} s in phase 1 "
              "(0: found built before this run)")
    root = os.path.join(here, "build", "blender_protocol", "lego")
    t0 = time.time()
    infos, _ = blender.read_cameras_from_transforms_cv(
        root, "transforms_train.json", True)
    read_s = time.time() - t0
    grid = _grid_points((-1.0, 1.0), CARVE_RES)
    t0 = time.time()
    keep = mask_filter_points(grid, infos)
    native_s = time.time() - t0
    # both routes over the first CARVE_NUMPY_MASKS masks (the NumPy
    # route's seconds kept the phase in time)
    some = infos[:CARVE_NUMPY_MASKS]
    t0 = time.time()
    keep_some = mask_filter_points(grid, some)
    some_s = time.time() - t0
    t0 = time.time()
    keep_np = mask_filter_points(grid, some, use_native=False)
    numpy_s = time.time() - t0
    diff = float((keep_some != keep_np).mean())
    print(f"phase 36: {CARVE_RES}^3 carve over {len(infos)} masks of "
          f"{infos[0].width}x{infos[0].height} (read in {read_s:.3f} s): "
          f"native {native_s:.3f} s, {int(keep.sum())} points kept; over "
          f"the first {len(some)}: native {some_s:.3f} s, NumPy "
          f"{numpy_s:.3f} s ({numpy_s / some_s:.1f}x), keep masks differ "
          f"on {diff:.3e} of the grid (band {CARVE_TIE_BAND}); "
          f"{os.cpu_count()} host cores; {smi}")
    if not (diff < CARVE_TIE_BAND and keep.any()):
        raise AssertionError(f"phase 36: the carvers differ on {diff}")
    del grid, keep, keep_some, keep_np, infos

    # --- 37. a COLMAP capture of JPEG frames through the CLIs --------------
    base = os.path.join(here, "build", "jpeg_protocol")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.time()
    scan = write_colmap_scene(base, *COLMAP_SIZE, dev,
                              n_splats=COLMAP_GT_SPLATS,
                              n_points=COLMAP_POINTS, jpeg=True,
                              twin=os.path.join(base, "progressive"))
    write_s = time.time() - t0
    frames = sorted(glob.glob(os.path.join(scan, "images", "*.jpg")))
    t0 = time.time()
    for path in frames:
        img = images.read(path)
    decode_s = time.time() - t0
    mpix = len(frames) * COLMAP_SIZE[0] * COLMAP_SIZE[1] / 1e6
    kind = sniff_scene_type(scan)
    print(f"phase 37: COLMAP scan ({kind}) of {len(frames)} baseline JPEG "
          f"frames (quality {JPEG_QUALITY}, 4:2:0) of {COLMAP_SIZE[0]}x"
          f"{COLMAP_SIZE[1]}, {COLMAP_POINTS} points, written with "
          f"phase 45's progressive twins in {write_s:.2f} s ({os.cpu_count()}"
          f" encoder threads); decode {decode_s * 1e3 / mpix:.3f} ms a "
          f"megapixel ({decode_s:.3f} s for {mpix:.2f} MP); {smi}")
    if not (kind == "Colmap" and len(frames) == COLMAP_VIEWS
            and img.shape == (COLMAP_SIZE[1], COLMAP_SIZE[0], 3)):
        raise AssertionError(f"phase 37: {kind}, {len(frames)} frames, "
                             f"{img.shape}")
    out = os.path.join(base, "dtu")
    env = dict(DATASET_ROOT=base, SCENE=COLMAP_SCAN, OUT=out,
               PC_ITER=DTU_ITERS)
    lines = (script_command_lines("run_dtu.sh", dict(env, ITERS=DTU_ITERS))
             [:2] + script_command_lines("run_dtu.sh", dict(
                 env, ITERS=DTU_FIELD_ITERS))[2:])
    for (_, argv) in (lines[0], lines[2]):
        name = os.path.basename(argv[argv.index("-m") + 1])
        iters = int(argv[argv.index("--iterations") + 1])
        blend_fwd.launches = blend_bwd.launches = 0
        with Timed("Colmap") as timed:
            res = train.main(argv)
        torch.cuda.synchronize()
        got = (blend_fwd.launches, blend_bwd.launches)
        launches["blend_fwd"][f"37 {name}"] = got[0]
        launches["blend_bwd"][f"37 {name}"] = got[1]
        if got != (iters, iters) or not np.isfinite(res.ms_per_it):
            raise AssertionError(f"phase 37 {name}: blend launches {got}, "
                                 f"{res.ms_per_it} ms/it")
        print(f"phase 37 {name}: {iters} iterations on the JPEG capture at "
              f"{COLMAP_SIZE[0] // 2}x{COLMAP_SIZE[1] // 2} (-r 2), "
              f"{res.ms_per_it:.3f} ms/it, step {res.step_ms:.3f} ms mean, "
              f"{int(res.stats.valid.sum())} splats at the end; reader "
              f"{timed.seconds('reader'):.3f} s for {COLMAP_VIEWS} JPEG "
              f"views; {smi}")
        del res
    _, render_argv = lines[3]
    run = render_argv[render_argv.index("-m") + 1]
    blend_fwd.launches = 0
    t0 = time.time()
    with Timed("Colmap") as timed:
        results = render.main(render_argv)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches["blend_fwd"]["37 render"] = blend_fwd.launches
    n_frames = 3 + 25
    yaml = read_results(os.path.join(run, "test", f"ours_{DTU_FIELD_ITERS}",
                                     "results.yaml"))
    if not (blend_fwd.launches == n_frames and np.isfinite(yaml["psnr"])
            and results["test"]["psnr"] == yaml["psnr"]):
        raise AssertionError(f"phase 37: render {blend_fwd.launches} blends,"
                             f" {yaml}")
    print(f"phase 37: render CLI on SplatFields3D, {n_frames} frames in "
          f"{render_s:.3f} s (scene load {timed.seconds('scene'):.3f} s, "
          f"metrics {timed.seconds('metrics'):.3f} s); test {yaml}; {smi}")
    # --- 45. the same capture as progressive JPEG ---------------------------
    loop_errs, partial_errs = progressive_phase(
        dev, smi, scan, os.path.join(base, "progressive"), launches)
    shutil.rmtree(base, ignore_errors=True)

    # --- 38. every video.gif of the run -------------------------------------
    t0 = time.time()
    worst = check_videos(video_log, smi)
    print(f"phase 38: {len(video_log.videos)} videos checked in "
          f"{time.time() - t0:.3f} s, worst share of a render line "
          f"{worst:.4f}; {smi}")

    # --- 39. the ResField zoo, card against CPU -----------------------------
    import copy

    from splatfields_torch.models import encoders
    from splatfields_torch.ops.segsum import sorted_segment_sum
    segsum = encoders.sorted_segment_sum
    seg_errs, worst_zoo = [], 0.0
    t0 = time.time()
    for case in ZOO_CASES:
        layer = zoo_layer(case, ZOO_CAP, ZOO_IN, ZOO_OUT, ZOO_RANK)
        x, kw = zoo_inputs(case, ZOO_N, ZOO_IN, ZOO_FRAME)
        cot = torch.randn(ZOO_N, ZOO_OUT,
                          generator=torch.Generator().manual_seed(2))
        outs = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            m = copy.deepcopy(layer).to(d)
            xs = x.to(d).requires_grad_(True)
            kws = {k: v.to(d) if torch.is_tensor(v) else v
                   for k, v in kw.items()}
            sums = []

            def spy(sidx, vals, n_rows, _sums=sums):
                _sums.append((sidx.detach(), vals.detach(), n_rows))
                return segsum(sidx, vals, n_rows)

            encoders.sorted_segment_sum = spy
            sorted_segment_sum.launches = 0
            try:
                y = m(xs, **kws)
                grads = torch.autograd.grad((y * cot.to(d)).sum(),
                                            [xs] + list(m.parameters()),
                                            allow_unused=True)
            finally:
                encoders.sorted_segment_sum = segsum
            if d.type == "cuda":
                torch.cuda.synchronize()
            n_launch = sorted_segment_sum.launches   # the card's, last
            outs[where] = [y.detach().cpu()] + [
                None if g is None else g.cpu() for g in grads]
        want_launch = 2 if case[0] == "lora_ngp" else 0
        if n_launch != want_launch:
            raise AssertionError(f"phase 39 {case[:3]}: {n_launch} segment "
                                 f"sum launches, want {want_launch}")
        if want_launch:
            launches["segsum"]["39 lora_ngp"] = n_launch
            for sidx, vals, n_rows in sums:
                seg_errs.append(check_segsum("phase 39 lora_ngp table VJP",
                                             sidx, vals, n_rows))
        for i, (a, b) in enumerate(zip(outs["card"], outs["cpu"])):
            if (a is None) != (b is None):
                raise AssertionError(f"phase 39 {case[:3]}: gradient {i} "
                                     "missing on one side")
            if a is None:
                continue
            scale = max(float(b.abs().max()), 1e-30)
            err = float((a - b).abs().max()) / scale
            worst_zoo = max(worst_zoo, err)
            if err > TOL_ZOO:
                raise AssertionError(f"phase 39 {case[:3]} {case[3]}: "
                                     f"{'output' if i == 0 else 'gradient'}"
                                     f" {i} differs by {err:.3e} of its max")
    print(f"phase 39: {len(ZOO_CASES)} ResField zoo members ({ZOO_IN}->"
          f"{ZOO_OUT}, capacity {ZOO_CAP}, rank {ZOO_RANK}, {ZOO_N} points)"
          f", forward and backward, card against CPU within {worst_zoo:.3e}"
          f" of each tree's max (TOL_ZOO {TOL_ZOO}); lora_ngp's table VJP: "
          f"{launches['segsum'].get('39 lora_ngp')} segment-sum launches, "
          f"kernel against plain within {max(seg_errs):.3e}; "
          f"{time.time() - t0:.1f} s; {smi}")
    return launches, seg_errs, loop_errs, partial_errs


# --- phases 40-41: the JAX package's bf16 defaults ------------------------------
# phase 40's small bf16 step, card against CPU: both round at the same
# points, and only the f32 sums' order differs (~1e-7 relative), so an
# activation lying that close to a bf16 rounding boundary rounds to the
# neighbouring value on one side: one bf16 step, 2^-8 relative, on that
# splat's attributes. A few splats at most; the bound allows every
# attribute one step: the loss within 2^-8 relative, the screen gradient
# within two steps (2^-7) of its max, a splat radius off by one pixel on
# at most 1% of the splats, parameters within 2^-7 of their lr (Adam's
# update from non-zero moments is smooth in the gradient) plus 1e-5
# relative.
BF16_STEP = 2.0 ** -8


def check_small_step_bf16(card, cpu):
    import torch

    from splatfields_torch.models import splats
    (sp_g, _, _, fp_g, _, out_g), (sp_c, _, _, fp_c, _, out_c) = card, cpu
    loss_g, loss_c = float(out_g.loss), float(out_c.loss)
    radii_off = int((out_g.radii.cpu() != out_c.radii).sum())
    radii_far = int(((out_g.radii.cpu() - out_c.radii).abs() > 1).sum())
    sg_c = out_c.screen_grad
    sg_err = float((out_g.screen_grad.cpu() - sg_c).abs().max()
                   / sg_c.abs().max())
    lrs = splats.tree_items(splats.splat_lr_tree(*SPLAT_LRS))
    worst = 0.0
    for tree_g, tree_c, lr_of in (
            (splats.tree_items(sp_g), splats.tree_items(sp_c), lrs.get),
            (fp_g, fp_c, lambda _: FIELD_LR)):
        for k, want in tree_c.items():
            err = float(((tree_g[k].cpu() - want).abs()
                         - 1e-5 * want.abs()).max()) if want.numel() else 0.0
            worst = max(worst, err / lr_of(k))
    n = out_c.radii.shape[0]
    print(f"small bf16 step: loss card {loss_g:.7f}, CPU {loss_c:.7f} "
          f"(bound {BF16_STEP} relative); radii differ on {radii_off} of {n} "
          f"(by more than 1: {radii_far}); screen_grad err over its max "
          f"{sg_err:.3e} (bound {2 * BF16_STEP}); updated params, worst err "
          f"over lr {worst:.3e} (bound {2 * BF16_STEP})")
    if not abs(loss_g - loss_c) <= BF16_STEP * abs(loss_c):
        raise AssertionError("small bf16 step: losses differ")
    if radii_far or radii_off > 0.01 * n:
        raise AssertionError("small bf16 step: radii differ")
    if not sg_err <= 2 * BF16_STEP:
        raise AssertionError("small bf16 step: screen_grad differs")
    if not worst <= 2 * BF16_STEP:
        raise AssertionError("small bf16 step: updated parameters differ")


def timed_steps(step, state, batches):
    """Phase 6's loop: TRAIN_WARMUP steps, then TRAIN_STEPS timed with
    CUDA events -> (ms/step, the first step's StepOut, the last state)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    first = None
    for i, b in enumerate(batches[:TRAIN_WARMUP + TRAIN_STEPS]):
        if i == TRAIN_WARMUP:
            start.record()
        *state, out = step(*state, b, splats_lrs(), FIELD_LR)
        first = first or out
    end.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.loss)):
        raise AssertionError("non-finite loss")
    return start.elapsed_time(end) / TRAIN_STEPS, first, state


def splats_lrs():
    from splatfields_torch.models import splats
    return splats.splat_lr_tree(*SPLAT_LRS)


def attribute_gap(net, params, stats, env, values) -> dict:
    """The field's attributes of ``params`` with ``env`` set to each of
    ``values``: per key, the largest difference over the largest value."""
    import torch

    from splatfields_torch import train_lib
    from splatfields_torch.models import splats
    outs = []
    with torch.no_grad():
        for v in values:
            os.environ[env] = v
            outs.append(train_lib.field_attributes(
                net, params.xyz, splats.get_scaling(params), stats.valid, 0.0,
                0))
    os.environ[env] = "off"
    return attribute_gaps(*outs)


def attribute_gaps(a, b) -> dict:
    """Per attribute, the largest difference of ``a`` from ``b`` over
    ``b``'s largest value."""
    return {k: float((a[k].float() - b[k].float()).abs().max()
                     / b[k].float().abs().max().clamp_min(1e-30))
            for k in ("means3d", "opacity", "scales", "rotations", "rgb")}


def bf16_phases(dev, smi):
    """Phases 40-41: the MLP's bf16 activations and the hash grid's bf16
    gather source, each off then on in one call. Returns ({kernel name:
    {phase: launches}}, phase 41's segment-sum error)."""
    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.segsum import sorted_segment_sum
    launches = {"blend_fwd": {}, "blend_bwd": {}, "segsum": {}}
    sc = serving_scene(dev)
    batches = training_batches(dev)
    steps = TRAIN_WARMUP + TRAIN_STEPS

    def fresh(deform):
        return (sc.params, sc.stats, splats.adam_init(sc.params),
                deform.params, deform.opt_state)

    # --- 40. SPLATFIELDS_MLP_BF16 off / on on phase 6's step ----------------
    ms, firsts = {}, {}
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = 0
    for mode in ("off", "on"):
        os.environ["SPLATFIELDS_MLP_BF16"] = mode
        step = train_step_fn(sc.deform, sc.pipe, RES)
        ms[mode], firsts[mode], _ = timed_steps(step, fresh(sc.deform),
                                                batches)
    os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    launches["blend_fwd"]["40"] = blend_fwd.launches
    launches["blend_bwd"]["40"] = blend_bwd.launches
    if (blend_fwd.launches, blend_bwd.launches) != (2 * steps, 2 * steps):
        raise AssertionError(f"phase 40: blend launches {blend_fwd.launches}"
                             f", {blend_bwd.launches} for {2 * steps} steps")
    gap = attribute_gap(sc.deform.net, sc.params, sc.stats,
                        "SPLATFIELDS_MLP_BF16", ("on", "off"))
    loss_gap = abs(float(firsts["on"].loss) - float(firsts["off"].loss))
    print(f"phase 40: SPLATFIELDS_MLP_BF16 off {ms['off']:.4f} ms/step, on "
          f"{ms['on']:.4f} ms/step ({RES}x{RES}, {N_SPLATS} splats, "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP}); on against off: the "
          f"field's attributes, largest difference over largest value "
          f"{gap}; first step's loss {float(firsts['off'].loss):.7f} / "
          f"{float(firsts['on'].loss):.7f} (gap {loss_gap:.3e}); {smi}")
    if not max(gap.values()) > 0:
        raise AssertionError("phase 40: bf16 did not change the attributes")
    res = {}
    cam = make_views(2, 64)[1]
    os.environ["SPLATFIELDS_MLP_BF16"] = "on"
    try:
        for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
            from splatfields_torch.models.deform_model import DeformModel
            p_, s_ = splats.create_from_pcd(sc.pts[:2000], sc.cols[:2000], 0,
                                            device=device)
            d_ = DeformModel(sc.hidden, radius=1.0, seed=0, device=device)
            res[name] = train_step_fn(d_, sc.pipe, 64)(
                p_, s_, nonzero_adam(p_, 1), d_.params,
                nonzero_adam(d_.params, 2),
                train_batch(cam, np.random.RandomState(1), device),
                splats_lrs(), FIELD_LR)
    finally:
        os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    print("phase 40: phase 7's small step with SPLATFIELDS_MLP_BF16=on, "
          "card against CPU:")
    check_small_step_bf16(res["cuda"], res["cpu"])

    # --- 41. SPLATFIELDS_NGP_BF16_TABLE off / on on phase 9's step ----------
    deform = ngp_model(dev)
    step = train_step_fn(deform, sc.pipe, RES)
    torch.cuda.synchronize()
    blend_fwd.launches = blend_bwd.launches = sorted_segment_sum.launches = 0
    for mode in ("off", "on"):
        os.environ["SPLATFIELDS_NGP_BF16_TABLE"] = mode
        ms[mode], firsts[mode], _ = timed_steps(step, fresh(deform), batches)
    got = (blend_fwd.launches, blend_bwd.launches, sorted_segment_sum.launches)
    launches["blend_fwd"]["41"], launches["blend_bwd"]["41"] = got[:2]
    launches["segsum"]["41"] = got[2]
    if got != (2 * steps,) * 3:
        raise AssertionError(f"phase 41: launches {got} for {2 * steps} "
                             "NGP steps")
    os.environ["SPLATFIELDS_NGP_BF16_TABLE"] = "on"
    try:
        _, (sidx, vals, n_rows) = capture_table_vjp(sc, deform, step,
                                                    batches[-1], splats_lrs())
    finally:
        os.environ["SPLATFIELDS_NGP_BF16_TABLE"] = "off"
    gap = attribute_gap(deform.net, sc.params, sc.stats,
                        "SPLATFIELDS_NGP_BF16_TABLE", ("on", "off"))
    loss_gap = abs(float(firsts["on"].loss) - float(firsts["off"].loss))
    print(f"phase 41: SPLATFIELDS_NGP_BF16_TABLE off {ms['off']:.4f} ms/step,"
          f" on {ms['on']:.4f} ms/step ({RES}x{RES}, {N_SPLATS} splats, "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP}); on against off: the "
          f"field's attributes {gap}; first step's loss gap {loss_gap:.3e}; "
          f"{smi}")
    if not max(gap.values()) > 0:
        raise AssertionError("phase 41: the bf16 table changed nothing")
    seg_err = check_segsum("phase 41, the bf16-table step's own rows", sidx,
                           vals, n_rows)
    del sc, deform
    torch.cuda.empty_cache()
    return launches, seg_err


# --- phase 42: multi-device on one card -------------------------------------
SLICE_RES = (808, 800)   # 51 x 50 tiles: 4 slices pad the grid by 2
MESH_ITERS = 5           # phase 42's CLI runs, resumed after iteration 1
WORLD_SPLATS = 2000      # phase 42's two-process world: phase 7's size
WORLD_TIMEOUT_S = 300


def slice_phase(sc, dev):
    """Phase 42 (a): both blend kernels on each rank's slice of a
    SLICE_RES training frame's tile grid (``parallel.step.local_tiles``:
    padded starts and counts, global ids clamped to the last tile) for 2
    and 4 model ranks, against the plain versions; each slice's forward
    equals the whole frame's on its tiles, and the slices' backward rows
    sum to the whole frame's backward."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.raster.blend_torch import (
        blend_bwd_plain,
        blend_sorted_plain,
    )
    from splatfields_torch.parallel.step import local_tiles, tile_slice
    w, h = SLICE_RES
    cam = make_views(2, RES)[1]
    cam.image_width, cam.image_height = w, h
    rng = np.random.RandomState(2)
    batch = train_batch(cam, rng, dev)
    batch["image"] = torch.as_tensor(rng.rand(1, 3, h, w).astype(np.float32),
                                     device=dev)
    step = train_lib.make_train_step(
        sc.deform.net, config.OptimizationConfig(lambda_mask=0.0,
                                                 lambda_norm=0.01),
        sc.pipe, w, h, 1, True, 0, 0)
    bargs = training_blend_args(sc, step, batch, splats_lrs())
    pack, start, counts, ids, *gs_outs = bargs[:10]
    tiles_x, ts, tc = bargs[10:13]
    tiles_y, num_tiles = -(-h // ts), counts.shape[0]
    gs = gs_outs[:3]
    full = blend_fwd(pack, start, counts, tiles_x, tiles_y, ts, tc, 128)
    full_grad = blend_bwd(pack, start, counts, ids, *gs, *full, tiles_x, ts,
                          tc)
    launches = [0, 0]
    for n_model in (2, 4):
        total = torch.zeros_like(full_grad)
        for m in range(n_model):
            s_, c_, i_ = local_tiles(start, counts, num_tiles, n_model, m)
            fwd_args = (pack, s_, c_, tiles_x, tiles_y, ts, tc, 128, i_)
            n0 = blend_fwd.launches
            got = blend_fwd(*fwd_args)
            launches[0] += blend_fwd.launches - n0
            label = f"phase 42, {n_model} model ranks, slice {m}"
            check_close(label, got, blend_sorted_plain(*fwd_args))
            first, t_loc = tile_slice(num_tiles, n_model, m)
            real = min(t_loc, num_tiles - first)   # past it: padding
            check_close(label + " against the whole frame",
                        [g[:real] for g in got],
                        [f[i_[:real].long()] for f in full])
            keep = torch.arange(t_loc, device=dev) < real
            g_loc = [g[i_.long()] * keep.view(-1, *[1] * (g.ndim - 1))
                     for g in gs]
            bwd_args = (pack, s_, c_, i_, *g_loc, *got)
            n0 = blend_bwd.launches
            grad = blend_bwd(*bwd_args, tiles_x, ts, tc)
            launches[1] += blend_bwd.launches - n0
            check_bwd(label + ", backward", grad,
                      blend_bwd_plain(*bwd_args, tiles_x, ts, tc, 128))
            total += grad
        check_bwd(f"phase 42, {n_model} slices' backward summed against the "
                  "whole frame's", total, full_grad)
    pad = -(-num_tiles // 4) * 4 - num_tiles
    print(f"phase 42 (a): {num_tiles} tiles ({tiles_x} x {tiles_y}), 4 "
          f"slices pad {pad}; blend_fwd {launches[0]} and blend_bwd "
          f"{launches[1]} launches on slices")
    if not pad:
        raise AssertionError("phase 42: SLICE_RES pads no slice")
    return launches


def world_rank(rank, world, store, out_path, seed, device_type="cuda"):
    """One rank of phase 42 (c)'s world: gloo, CUDA tensors on the one
    card (``device_type``), a 1 x ``world`` mesh, one sharded field step
    of phase 7's configuration with two views; rank 0 saves the whole
    state."""
    import torch
    import torch.distributed as dist

    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.parallel import mesh as mesh_lib
    from splatfields_torch.parallel import step as pstep
    os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    dev = torch.device(device_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh_lib.initialize_distributed(None, world, rank, backend="gloo",
                                    init_method=f"file://{store}",
                                    timeout_s=WORLD_TIMEOUT_S)
    mesh = mesh_lib.make_mesh(world)
    state, step_args = world_case(dev, mesh, seed)
    blend_fwd.launches = blend_bwd.launches = 0
    out = pstep.make_sharded_train_step(*step_args)(*state)
    p, s, o = pstep.unshard_train_state(*out[:3], mesh)
    torch.cuda.synchronize()
    counts = [blend_fwd.launches, blend_bwd.launches]
    all_counts = mesh_lib.all_reduce(torch.tensor(counts, device=dev),
                                     mesh.model_group)
    dist.destroy_process_group()
    if rank == 0:
        torch.save({"params": splats.tree_items(p),
                    "max_radii2d": s.max_radii2d, "field": out[3],
                    "loss": out[5].loss, "launches": all_counts.tolist()},
                   out_path)


def world_case(dev, mesh, seed):
    """Phase 42 (c)'s state and step arguments: phase 7's field step with
    two views (``mesh`` None: the single-device step's arguments)."""
    import torch

    from splatfields_torch import config
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.parallel import step as pstep
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (WORLD_SPLATS, 3)).astype(np.float32)
    cols = rng.rand(WORLD_SPLATS, 3).astype(np.float32)
    p_, s_ = splats.create_from_pcd(pts, cols, 0, device=dev)
    d_ = DeformModel(config.HiddenConfig(encoder_type="VarTriPlaneEncoder",
                                         composition_rank=0, n_frames=0),
                     radius=1.0, seed=seed, device=dev)
    cams = make_views(3, 64)[1:]
    r = np.random.RandomState(1)
    b = [train_batch(c, r, dev) for c in cams]
    batch = dict(b[0])
    for k in ("viewmatrix", "projmatrix", "campos", "image"):
        batch[k] = torch.cat([x[k] for x in b])
    batch["tanfovx"] = [x["tanfovx"][0] for x in b]
    batch["tanfovy"] = [x["tanfovy"][0] for x in b]
    state = [p_, s_, nonzero_adam(p_, 1), d_.params,
             nonzero_adam(d_.params, 2)]
    opt = config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01)
    pipe = config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128)
    if mesh is None:
        from splatfields_torch import train_lib
        step_args = (d_.net, opt, pipe, 64, 64, 2, True, 0, 0)
        return state + [batch, splats_lrs(), FIELD_LR], step_args
    state[:3] = pstep.shard_train_state(*state[:3], mesh)
    step_args = (d_.net, opt, pipe, 64, 64, 2, True, 0, mesh, 0)
    return state + [batch, splats_lrs(), FIELD_LR], step_args


def mesh_phases(dev, smi):
    """Phase 42: the multi-device path on one card. Returns {kernel name:
    {phase: launches}}."""
    import shutil
    import time

    import torch
    import torch.multiprocessing as mp

    from splatfields_torch import train, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    here = os.path.dirname(os.path.abspath(__file__))

    # --- (a) the blend kernels on tile slices -------------------------------
    sc = serving_scene(dev)
    sliced = slice_phase(sc, dev)
    del sc
    torch.cuda.empty_cache()

    # --- (b) the CLI on a world of 1 over NCCL ------------------------------
    # both runs resume from one run's state after iteration 1: the first
    # Adam step (zero moments) is lr * g / (|g| + eps), which turns the
    # card's atomics' summation noise into updates of up to lr; from
    # non-zero moments the loop is smooth in the gradient
    proto = os.path.join(here, "build", "blender_protocol")
    pc = os.path.join(proto, "out", "3DGS", "point_cloud", "iteration_300",
                      "point_cloud.ply")
    argv = (["-s", os.path.join(proto, "lego")] + PROTOCOL_FIELD
            + ["--pc_path", pc, "--test_iterations", str(MESH_ITERS),
               "--quiet"])
    first = os.path.join(proto, "out", "mesh_single")
    shutil.rmtree(first, ignore_errors=True)
    train.main(argv + ["-m", first, "--iterations", "1"])
    runs, cli_launches, losses = {}, [0, 0], {}
    training = train.training

    def spy(*args, **kw):
        """``training`` with every iteration's loss kept."""
        got, callback = [], kw.get("progress_callback")

        def both(it, loss, *rest):
            got.append(loss)
            if callback:
                callback(it, loss, *rest)

        losses[spy.run] = got
        return training(*args, **dict(kw, progress_callback=both))

    train.training = spy
    shutil.rmtree(first.replace("single", "mesh"), ignore_errors=True)
    shutil.copytree(first, first.replace("single", "mesh"))
    for name, extra in (("single", []), ("mesh", ["--mesh_model", "1"])):
        spy.run = name
        torch.cuda.synchronize()
        blend_fwd.launches = blend_bwd.launches = 0
        t0 = time.time()
        runs[name] = train.main(
            argv + ["-m", first.replace("single", name), "--iterations",
                    str(MESH_ITERS), "--resume"] + extra)
        torch.cuda.synchronize()
        print(f"phase 42 (b): run_blender.sh's SplatFields3D line, resumed "
              f"from iteration 1 to {MESH_ITERS}, {name}: "
              f"{time.time() - t0:.1f} s, {runs[name].ms_per_it:.3f} ms/it, "
              f"best PSNR {runs[name].best_psnr:.4f}")
        if name == "mesh":
            cli_launches = [blend_fwd.launches, blend_bwd.launches]
    train.training = training
    if torch.distributed.is_initialized():
        raise AssertionError("phase 42: the CLI left its process group")
    a, b = runs["single"], runs["mesh"]
    rel = (np.abs(np.subtract(losses["mesh"], losses["single"]))
           / np.abs(losses["single"]))
    gaps = {k: float((getattr(b.params, k) - getattr(a.params, k)).abs().max())
            for k in splats.tree_items(a.params)}
    gaps["field"] = max(float((b.deform.params[k] - v).abs().max())
                        for k, v in a.deform.params.items())
    print(f"phase 42 (b): the world-of-1 NCCL mesh against no mesh: losses "
          f"{losses['single']} / {losses['mesh']}, worst rel {rel.max():.3e};"
          f" largest difference of the final state per leaf {gaps}; PSNR "
          f"{a.best_psnr:.6f} / {b.best_psnr:.6f}; blend launches "
          f"{cli_launches}; {smi}")
    # phase 17's criterion for two runs of one loop: each iteration's loss
    # within 1e-5 relative (the card's atomics sum in any order)
    if not (len(rel) == MESH_ITERS - 1 and rel.max() <= 1e-5
            and abs(a.best_psnr - b.best_psnr) <= 1e-3
            and cli_launches == [MESH_ITERS - 1 + len(PROTOCOL_TEST_THETAS)
                                 + 5, MESH_ITERS - 1]):
        raise AssertionError("phase 42: the mesh run differs from the run "
                             "without a mesh")

    # --- (c) a world of 2 processes on the one card over gloo ---------------
    base = os.path.join(here, "build", "mesh_world")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    out_path = os.path.join(base, "rank0.pt")
    t0 = time.time()
    ctx = mp.start_processes(
        world_rank, args=(2, os.path.join(base, "store"), out_path, 0,
                          dev.type),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.0)):
            if time.time() >= deadline:
                raise TimeoutError("phase 42: the 2-process world did not "
                                   f"end in {WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    world_s = time.time() - t0
    got = torch.load(out_path, map_location=dev)
    state, step_args = world_case(dev, None, 0)
    want = train_lib.make_train_step(*step_args)(*state)
    loss_gap = abs(float(got["loss"]) - float(want[5].loss))

    def past_rtol(a, b):   # abs err past 1e-4 relative, JAX's tolerance
        if not b.numel():
            return 0.0
        return float(((a - b).abs() - 1e-4 * b.abs()).max())

    gaps = {k: past_rtol(v, getattr(want[0], k))
            for k, v in got["params"].items()}
    gaps["field"] = max(past_rtol(got["field"][k], v)
                        for k, v in want[3].items())
    radii_eq = torch.equal(got["max_radii2d"], want[1].max_radii2d)
    print(f"phase 42 (c): 2 processes on one card over gloo (CUDA tensors), "
          f"1 x 2 mesh, {WORLD_SPLATS} splats, 64x64, 2 views: {world_s:.1f} "
          f"s; against the single-device step: loss gap {loss_gap:.3e}, "
          f"parameters' worst abs err past 1e-4 relative {gaps}, max_radii2d "
          f"equal {radii_eq}; blend launches in the world {got['launches']}")
    if not (loss_gap < 1e-4 and max(gaps.values()) <= 2e-5 and radii_eq):
        raise AssertionError("phase 42: the 2-process world differs from "
                             "the single-device step")
    if got["launches"] != [4, 4]:
        raise AssertionError(f"phase 42: the world launched "
                             f"{got['launches']}, not 2 views x 2 ranks")
    shutil.rmtree(base, ignore_errors=True)
    return {"blend_fwd": {"42": sliced[0] + cli_launches[0]
                          + got["launches"][0]},
            "blend_bwd": {"42": sliced[1] + cli_launches[1]
                          + got["launches"][1]}}


# --- phases 43-44: the JAX package's off-by-default field options ------------
# phase 44: each option on phase 6's workload (phase 9's for the NGP one,
# the owlii4d step at 1 view and composition_rank 0 for the 4-D fused
# heads: a rank-40 field fuses nothing), TRAIN_WARMUP warm-ups and
# PAIR_STEPS timed steps, the GPU idle share over one profiled step (the
# profiler's own cost kept the phase in time); QUAD_MULTI with
# PLANE_GRAD_PALLAS is phase 43's, on a step's own rows
PAIR_STEPS = 4
# (label, environment, fuse_heads, bf16 numerics): the static field options
PLANE_OPTIONS = (
    ("QUAD_SAMPLE", {"SPLATFIELDS_QUAD_SAMPLE": "on"}, False, False),
    ("PLANE_BF16", {"SPLATFIELDS_PLANE_BF16": "on"}, False, True),
    ("QUAD_MULTI", {"SPLATFIELDS_QUAD_MULTI": "on"}, False, False),
    ("PLANE_GRAD_PALLAS", {"SPLATFIELDS_PLANE_GRAD_PALLAS": "on"}, False,
     False),
    ("SORTED_PLANE_GRAD", {"SPLATFIELDS_SORTED_PLANE_GRAD": "on"}, False,
     False),
    ("PACKED_CNN", {"SPLATFIELDS_PACKED_CNN": "on"}, False, False),
    ("CNN_BF16", {"SPLATFIELDS_CNN_BF16": "on"}, False, True),
    ("fuse_heads", {}, True, False))
PLANE_ENVS = ("SPLATFIELDS_QUAD_SAMPLE", "SPLATFIELDS_PLANE_BF16",
              "SPLATFIELDS_QUAD_MULTI", "SPLATFIELDS_PLANE_GRAD_PALLAS",
              "SPLATFIELDS_SORTED_PLANE_GRAD", "SPLATFIELDS_PACKED_CNN",
              "SPLATFIELDS_CNN_BF16", "SPLATFIELDS_NGP_SORTED_GRAD")
F32_EPS = 2.0 ** -24
# phase 43: the cumsum route (SORTED_PLANE_GRAD) card against CPU, in f32
# units (u) of the column's absolute running sum. Both run f32 prefix sums
# in other orders: an H100 run read 4.6 u, the CPU's own error against
# float64 1.6 u. 64 u stays an order above those; a running sum kept in
# bf16 (steps of 2^-8, 2^16 u) sits far past it (phase 43 prints one)
CUMSUM_TOL_U = 64
# phase 44's small steps card against CPU: phase 7's configuration with
# the decoder at 4x4 noise (32x32 planes), so that the CPU's side stays
# short; the 4-D one SMALL_4D's at composition_rank 0
SMALL_OPTION_HIDDEN = dict(encoder_type="VarTriPlaneEncoder",
                           composition_rank=0, n_frames=0,
                           encoder_args={"noise_res": 4})


class Env:
    """Inside ``with``: the environment variables ``values`` set, restored
    (or removed) after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pack_tensorial(subs, packed):
    """Copy the weights of P unpacked ``Tensorial2D`` modules into one
    packed with ``n_packs=P`` (``SPLATFIELDS_PACKED_CNN``): the grouped
    convs' weights, per-frame deltas and biases, the GroupNorm affines and
    the noise concatenate pack-major; the attention's projections stack
    into its block-diagonal kernels ([in, out] each) and biases. The
    packed module then computes the P planes of the unpacked ones."""
    import torch
    sds = [s.state_dict() for s in subs]
    state = {}
    for key in packed.state_dict():
        *mod, leaf = key.split(".")
        if leaf.startswith("to_") and leaf.endswith(("_kernel", "_bias")):
            name, kind = leaf.rsplit("_", 1)
            src = ".".join(mod + [name, "weight" if kind == "kernel"
                                  else "bias"])
            state[key] = torch.stack([sd[src].t() if kind == "kernel"
                                      else sd[src] for sd in sds])
        else:
            dim = 1 if leaf in ("frame_weights", "noise") else 0
            state[key] = torch.cat([sd[key] for sd in sds], dim=dim)
    packed.load_state_dict(state)


def option_model(hidden, env, fuse, dev, like=None):
    """The field model of ``hidden`` (a ``HiddenConfig`` or its keywords;
    seed 0) built under ``env``, with ``fuse_heads``; under
    ``SPLATFIELDS_PACKED_CNN`` its packed decoder takes the weights of
    ``like``'s (a default model's) three."""
    from splatfields_torch import config
    from splatfields_torch.models.deform_model import DeformModel
    if isinstance(hidden, dict):
        hidden = config.HiddenConfig(**hidden)
    with Env(env):
        deform = DeformModel(hidden, radius=1.0, seed=0, device=dev)
    deform.net.fuse_heads = fuse
    enc = deform.net.encoder
    if getattr(enc, "packed", False):
        pack_tensorial([getattr(like.net.encoder, f"subs_{i}")
                        for i in range(enc.n_planes)], enc.subs_packed)
        deform.params = {k: v.detach() for k, v in
                         deform.net.named_parameters()}
    return deform


def option_run(dev, label, deform, n_frames, batches, pts, cols, env):
    """TRAIN_WARMUP + PAIR_STEPS steps of ``deform`` under ``env`` (the
    last PAIR_STEPS timed), then one profiled. -> (ms/step, idle share,
    its GPU busy ms, blend launches, segment-sum launches)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
    from splatfields_torch.ops.segsum import sorted_segment_sum
    pipe = config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128)
    step = train_lib.make_train_step(
        deform.net, config.OptimizationConfig(lambda_mask=0.0,
                                              lambda_norm=0.01),
        pipe, RES, RES, 1, True, n_frames, 0)
    sp, st = splats.create_from_pcd(pts, cols, 0, capacity=N_SPLATS,
                                    device=dev)
    state = [sp, st, splats.adam_init(sp), deform.params, deform.opt_state]
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    n_steps = TRAIN_WARMUP + PAIR_STEPS
    with Env(env):
        torch.cuda.synchronize()
        blend_fwd.launches = blend_bwd.launches = 0
        sorted_segment_sum.launches = 0
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        for i, b in enumerate(batches[:n_steps]):
            if i == TRAIN_WARMUP:
                start.record()
            *state, out = step(*state, b, lrs, FIELD_LR)
        end.record()
        torch.cuda.synchronize()
        launches = (blend_fwd.launches, blend_bwd.launches,
                    sorted_segment_sum.launches)
        if not bool(torch.isfinite(out.loss)):
            raise AssertionError(f"{label}: non-finite loss")
        if launches[:2] != (n_steps, n_steps):
            raise AssertionError(f"{label}: blend launches {launches[:2]} "
                                 f"for {n_steps} steps")

        def run1():
            state[:5] = step(*state, batches[n_steps], lrs, FIELD_LR)[:5]
            torch.cuda.synchronize()

        _, busy_ms, idle, _ = device_idle(run1)
    return (start.elapsed_time(end) / PAIR_STEPS, idle, busy_ms,
            launches[:2], launches[2])


def option_attributes(deform, env, n_frames, pts, dev):
    """The field's attributes of ``deform`` (its initial weights) at the
    splats of ``pts`` under ``env``."""
    import torch

    from splatfields_torch import train_lib
    from splatfields_torch.models import splats
    sp, st = splats.create_from_pcd(pts, pts, 0, capacity=N_SPLATS,
                                    device=dev)
    fid = 0.5 if n_frames else 0.0
    with Env(env), torch.no_grad():
        return train_lib.field_attributes(
            deform.net, sp.xyz, splats.get_scaling(sp), st.valid, fid,
            n_frames)


def small_option_step(hidden, env, fuse, bf16, n_frames, dev, pts, cols):
    """Phase 7's small step (2,000 splats, 64x64, the net of ``hidden``;
    4-D: SMALL_4D's sizes at composition_rank 0, 2 views) with one
    option, on the card and on the CPU from the same weights, held as
    phase 7 holds it (bf16 options: ``check_small_step_bf16``)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    res = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        like = None if n_frames else option_model(hidden, {}, False, device)
        with Env(env):
            if n_frames:
                net = small_4d_net(device, 0, **dict(SMALL_4D,
                                                     composition_rank=0))
                net.fuse_heads = fuse
                fp = {k: v.detach() for k, v in net.named_parameters()}
                step = train_lib.make_train_step(
                    net, config.OptimizationConfig(lambda_mask=0.0,
                                                   lambda_norm=0.01),
                    config.PipelineConfig(tile_size=16, tile_cap=1024,
                                          k_chunk=128),
                    64, 64, 2, True, SMALL_4D["n_frames"], 0)
                batch = owlii_batch(make_views(3, 64)[1:], 2 / 3,
                                    np.random.RandomState(1), device)
            else:
                d_ = option_model(hidden, env, fuse, device, like=like)
                fp = d_.params
                step = train_step_fn(d_, config.PipelineConfig(
                    tile_size=16, tile_cap=1024, k_chunk=128), 64)
                batch = train_batch(make_views(2, 64)[1],
                                    np.random.RandomState(1), device)
            p_, s_ = splats.create_from_pcd(pts[:2000], cols[:2000], 0,
                                            device=device)
            res[name] = step(p_, s_, nonzero_adam(p_, 1), fp,
                             nonzero_adam(fp, 2), batch,
                             splats.splat_lr_tree(*SPLAT_LRS), FIELD_LR)
    (check_small_step_bf16 if bf16 else check_small_step)(res["cuda"],
                                                          res["cpu"])


def capture_plane_grads(sc, env, dev):
    """One full-width phase-6 step under ``env`` with the quad table's VJP
    captured: every ``quad_table_grad`` call's (route, idx, w4, g, n_rows)
    and every ``sorted_segment_sum`` call's (sidx, vals, n_rows) it
    made."""
    from splatfields_torch.models import splats
    from splatfields_torch.ops import grid_sample
    grads, sums = [], []
    table_grad, segsum = (grid_sample.quad_table_grad,
                          grid_sample.sorted_segment_sum)

    def grad_spy(route, idx, w4, g, n_rows):
        grads.append((route, idx.detach(), w4.detach(), g.detach(), n_rows))
        return table_grad(route, idx, w4, g, n_rows)

    def segsum_spy(sidx, vals, n_rows):
        sums.append((sidx.detach(), vals.detach(), n_rows))
        return segsum(sidx, vals, n_rows)

    deform = option_model(sc.hidden, env, False, dev)
    step = train_step_fn(deform, sc.pipe, RES)
    grid_sample.quad_table_grad = grad_spy
    grid_sample.sorted_segment_sum = segsum_spy
    try:
        with Env(env):
            step(sc.params, sc.stats, splats.adam_init(sc.params),
                 deform.params, deform.opt_state, training_batches(dev)[-1],
                 splats_lrs(), FIELD_LR)
    finally:
        grid_sample.quad_table_grad = table_grad
        grid_sample.sorted_segment_sum = segsum
    return grads, sums


def plane_segsum_phase(sc, dev, smi):
    """Phase 43: the segment-sum kernel on the plane gradient's own rows.
    Returns the segment sum's plane entries for the kernels line."""
    import torch

    from splatfields_torch.models.encoders import _SPACE_AXES
    from splatfields_torch.ops import grid_sample
    from splatfields_torch.ops.segsum import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )
    entry = {"plane_grad_max_abs_err": {}, "plane_grad_ms": {},
             "plane_grad_graph_ms": {}, "plane_grad_plain_ms": {},
             "plane_grad_library_ms": {}, "plane_grad_bound_ms": {},
             "plane_grad_route_ms": {}}
    one = {"SPLATFIELDS_PLANE_GRAD_PALLAS": "on"}
    multi = dict(one, SPLATFIELDS_QUAD_MULTI="on")
    (grads, sums), (_, sums_m) = (capture_plane_grads(sc, one, dev),
                                  capture_plane_grads(sc, multi, dev))
    if len(sums) != 3 or len(sums_m) != 1:
        raise AssertionError(f"phase 43: {len(sums)} and {len(sums_m)} "
                             "segment sums, want 3 and 1")
    for label, (sidx, vals, n_rows) in (("one plane", sums[0]),
                                        ("QUAD_MULTI", sums_m[0])):
        err = check_segsum(f"phase 43, the plane gradient, {label}", sidx,
                           vals, n_rows)
        if vals.shape[1] != 64:
            raise AssertionError(f"phase 43: D {vals.shape[1]}, want 64")
        d = vals.shape[1]
        ms = cuda_ms(lambda: sorted_segment_sum(sidx, vals, n_rows), 20)
        graph = graph_ms(lambda: sorted_segment_sum(sidx, vals, n_rows), 20)
        plain = cuda_ms(lambda: sorted_segment_sum_plain(sidx, vals, n_rows),
                        5)
        lib = cuda_ms(lambda: torch.zeros(n_rows, d, device=dev).index_add_(
            0, sidx, vals), 5)
        bytes_moved = sidx.numel() * 4 + vals.numel() * 4 + n_rows * d * 4
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    vals.numel() / F32_FLOPS) * 1e3
        for key, v in (("max_abs_err", err), ("ms", ms), ("graph_ms", graph),
                       ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound)):
            entry[f"plane_grad_{key}"][label] = v
        print(f"phase 43, {label}: sorted_segment_sum {ms:.5f} ms (graph "
              f"replay {graph:.5f}), plain {plain:.5f}, index_add_ {lib:.5f}"
              f"; {sidx.numel()} slots, {n_rows} rows, D {d}, "
              f"{bytes_moved} bytes, bound {bound:.5f} ms (bytes); {smi}")
    # one plane's whole table VJP by each route, and F.grid_sample's
    # backward for the same plane gradient
    _, idx, w4, g, n_rows = grads[0]
    route_ms = {r: cuda_ms(lambda r=r: grid_sample.quad_table_grad(
        r, idx, w4, g, n_rows), 10) for r in grid_sample.GRAD_ROUTES}
    # the plane whose table that VJP was, by its rows
    xyz = sc.params.xyz.detach()
    all_planes = sc.deform.net.generate_planes().detach()
    h, w = all_planes.shape[2:]
    (i, coords), = [(i, xyz[:, list(ax)]) for i, ax in enumerate(_SPACE_AXES)
                    if torch.equal(grid_sample.quad_idx_w(xyz[:, list(ax)],
                                                          h, w)[0], idx)]
    planes = all_planes[i:i + 1].requires_grad_()
    out = grid_sample.grid_sample_planes(planes, coords[None])
    gs_ms = cuda_ms(lambda: torch.autograd.grad(
        out, planes, g[:, None], retain_graph=True), 10)
    route_ms["F.grid_sample backward"] = gs_ms
    entry["plane_grad_route_ms"] = route_ms
    print(f"phase 43: one plane's table VJP ({idx.shape[0]} points, "
          f"{h}x{w}x{g.shape[1]}), ms by route: {route_ms}; {smi}")
    # the cumsum route (SORTED_PLANE_GRAD) at N = 100,000, card against
    # CPU: its error is absolute, on the order of the running sum
    got = grid_sample.quad_table_grad("cumsum", idx, w4, g, n_rows)
    want = grid_sample.quad_table_grad("cumsum", idx.cpu(), w4.cpu(),
                                       g.cpu(), n_rows)
    rows = grid_sample._expand(g, w4).double()
    prefix = rows.abs().sum(0).cpu()           # the running sum's reach
    n = idx.shape[0]
    gap = ((got.cpu().double() - want.double()).abs().amax(0) / prefix
           .clamp_min(1e-30))
    exact = grid_sample.quad_table_grad("scatter", idx.cpu(), w4.cpu(),
                                        g.cpu().double(), n_rows)
    own = ((want.double() - exact).abs().amax(0) / prefix.clamp_min(1e-30))
    witness = (bf16_prefix_rows(idx, w4, g, n_rows).cpu().double()
               - want.double()).abs().amax(0) / prefix.clamp_min(1e-30)
    bound = CUMSUM_TOL_U * F32_EPS
    entry["cumsum_gap_over_prefix"] = float(gap.max())
    print(f"phase 43: SORTED_PLANE_GRAD's prefix sums at N = {n}: card "
          f"against CPU, largest gap over the column's absolute running "
          f"sum {float(gap.max()):.3e} (bound {CUMSUM_TOL_U} u = "
          f"{bound:.3e}; {float(gap.max()) / F32_EPS:.1f} u); the CPU's own "
          f"error against f64 {float(own.max()):.3e}; the same sums in bf16 "
          f"on the card {float(witness.max()):.3e} "
          f"({float(witness.max()) / F32_EPS:.1f} u); largest absolute gap "
          f"{float((got.cpu() - want).abs().max()):.3e}, largest entry "
          f"{float(want.abs().max()):.3e}")
    if not float(gap.max()) <= bound:
        raise AssertionError("phase 43: the cumsum route, card against CPU")
    return entry


def bf16_prefix_rows(idx, w4, g, n_rows):
    """``ops/grid_sample.segment_rows_sum`` with its running sum kept in
    bf16: the precision fault that phase 43's CUMSUM_TOL_U must catch."""
    import torch

    from splatfields_torch.ops import grid_sample
    c = g.shape[1]
    sidx, order = torch.sort(idx, stable=True)
    sp = torch.cat([g, w4], dim=1).index_select(0, order)
    rows = grid_sample._expand(sp[:, :c], sp[:, c:]).to(torch.bfloat16)
    csum = torch.cumsum(rows, dim=0).float()
    csum0 = torch.cat([csum.new_zeros(1, 4 * c), csum], dim=0)
    edges = torch.searchsorted(sidx, torch.arange(
        n_rows + 1, dtype=sidx.dtype, device=idx.device), side="left")
    seg = csum0.index_select(0, edges)
    return seg[1:] - seg[:-1]


def plane_phases(dev, smi):
    """Phases 43-44: the JAX package's off-by-default options. Returns
    (the segment sum's entries for the kernels line, {kernel name:
    {phase: launches}})."""
    import time

    import torch

    launches = {"blend_fwd": {}, "blend_bwd": {}, "segsum": {}}
    for name in PLANE_ENVS:
        if name in os.environ:
            raise AssertionError(f"phases 43-44: {name} is set")
    sc = serving_scene(dev)
    # --- 43. the segment sum on the plane gradient ---------------------------
    entry = plane_segsum_phase(sc, dev, smi)
    torch.cuda.empty_cache()

    # --- 44. every option, default then on, in one call -------------------
    rng = np.random.RandomState(0)
    batches = [train_batch(c, rng, dev)
               for c in make_views(TRAIN_WARMUP + PAIR_STEPS + 1, RES)]
    pts, cols = sc.pts, sc.cols
    default = option_model(sc.hidden, {}, False, dev)
    base = option_attributes(default, {}, 0, pts, dev)
    rows = {}
    cases = [("default", {}, False, False)] + list(PLANE_OPTIONS)
    t0 = time.time()
    for label, env, fuse, bf16 in cases:
        deform = (default if label == "default" else
                  option_model(sc.hidden, env, fuse, dev, like=default))
        ms, idle, busy, blends, seg = option_run(
            dev, label, deform, 0, batches, pts, cols, env)
        gap = max(attribute_gaps(option_attributes(deform, env, 0, pts, dev),
                                 base).values())
        rows[label] = (ms, idle, gap)
        phase = f"44 {label}"
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = blends
        want_seg = {"PLANE_GRAD_PALLAS": 3 * (TRAIN_WARMUP
                                              + PAIR_STEPS)}.get(label, 0)
        if seg != want_seg:
            raise AssertionError(f"phase 44 {label}: {seg} segment sums, "
                                 f"want {want_seg}")
        if want_seg:
            launches["segsum"][phase] = seg
        print(f"phase 44 {label}: phase 6's step {ms:.4f} ms/step "
              f"({PAIR_STEPS} steps after {TRAIN_WARMUP}), GPU idle share "
              f"{idle:.4f} (busy {busy:.3f} ms in 1 step), attributes' "
              f"gap to the default {gap:.3e}, blend launches {blends}, "
              f"segment sums {seg}; {time.time() - t0:.1f} s in; {smi}")
        if label != "default":
            small_option_step(SMALL_OPTION_HIDDEN, env, fuse, bf16, 0, dev,
                              pts, cols)
        if deform is not default:
            del deform
        torch.cuda.empty_cache()
    # f32 options compute the default's function; bf16 ones round it
    for label, _, _, bf16 in cases:
        gap = rows[label][2]
        if not (gap > 0 if bf16 else gap < 1e-4):
            raise AssertionError(f"phase 44 {label}: attributes' gap {gap}")

    # NGP_SORTED_GRAD=off on phase 9's step (auto: the sorted VJP)
    ngp = ngp_model(dev)
    ngp_base = option_attributes(ngp, {}, 0, pts, dev)
    for label, env in (("NGP default", {}),
                       ("NGP_SORTED_GRAD=off",
                        {"SPLATFIELDS_NGP_SORTED_GRAD": "off"})):
        deform = ngp if not env else option_model(NGP_HIDDEN, env, False,
                                                  dev)
        ms, idle, busy, blends, seg = option_run(
            dev, label, deform, 0, batches, pts, cols, env)
        gap = max(attribute_gaps(option_attributes(deform, env, 0, pts, dev),
                                 ngp_base).values())
        want = 0 if env else TRAIN_WARMUP + PAIR_STEPS
        if seg != want:
            raise AssertionError(f"phase 44 {label}: {seg} segment sums, "
                                 f"want {want}")
        print(f"phase 44 {label}: phase 9's step {ms:.4f} ms/step, GPU idle "
              f"share {idle:.4f} (busy {busy:.3f} ms in 1 step), "
              f"attributes' gap {gap:.3e}, segment sums {seg}; "
              f"{time.time() - t0:.1f} s in; {smi}")
    small_option_step(dict(NGP_HIDDEN, **NGP_SMALL),
                      {"SPLATFIELDS_NGP_SORTED_GRAD": "off"}, False, False, 0,
                      dev, pts, cols)
    del ngp, deform
    torch.cuda.empty_cache()

    # fuse_heads on the owlii4d step (1 view, composition_rank 0)
    hidden_4d = dict(OWLII_HIDDEN, composition_rank=0)
    rng = np.random.RandomState(1)
    frames = rng.permutation(OWLII_FRAMES)[:TRAIN_WARMUP + PAIR_STEPS + 1]
    cams = make_views(len(frames), RES)
    b4 = [owlii_batch([c], float(f) / (OWLII_FRAMES - 1), rng, dev)
          for c, f in zip(cams, frames)]
    base4 = None
    for label, fuse in (("4-D default", False), ("4-D fuse_heads", True)):
        deform = option_model(hidden_4d, {}, fuse, dev)
        ms, idle, busy, blends, _ = option_run(
            dev, label, deform, OWLII_FRAMES, b4, pts, cols, {})
        attrs = option_attributes(deform, {}, OWLII_FRAMES, pts, dev)
        base4 = base4 or attrs
        gap = max(attribute_gaps(attrs, base4).values())
        launches["blend_fwd"][f"44 {label}"] = blends[0]
        launches["blend_bwd"][f"44 {label}"] = blends[1]
        print(f"phase 44 {label}: the owlii4d step at 1 view, "
              f"composition_rank 0, {ms:.4f} ms/step, GPU idle share "
              f"{idle:.4f} (busy {busy:.3f} ms in 1 step), attributes' "
              f"gap {gap:.3e}; {time.time() - t0:.1f} s in; {smi}")
        if fuse and not gap < 1e-4:
            raise AssertionError(f"phase 44 {label}: gap {gap}")
        del deform
    small_option_step(None, {}, True, False, SMALL_4D["n_frames"], dev, pts,
                      cols)
    del sc
    torch.cuda.empty_cache()
    return entry, launches


LONGRUN_ITERS = 6         # phase 46's run, cut from 30,000: two legs of 3
LONGRUN_FLAGS = ["--eval_every", "3", "--save_every", "3",
                 "--densify_from_iter", "2", "--densification_interval", "3"]
LONGRUN_EVAL_FRAMES = 2 + 5   # evaluate(): the test views and 5 train views


def longrun_phase(dev, smi):
    """Phase 46: ``scripts/longrun_torch.py`` at full width in two legs.
    Returns ({kernel name: {phase: launches}}, {phase: check_loop_blends'
    errors})."""
    import shutil
    import time

    import torch

    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    t_phase = time.time()
    longrun = _script("longrun_torch")
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "longrun")
    shutil.rmtree(base, ignore_errors=True)
    run = os.path.join(base, "run")
    argv = ["--iters", str(LONGRUN_ITERS), "--scene_dir",
            os.path.join(base, "scene"), "--run_dir", run] + LONGRUN_FLAGS
    half = LONGRUN_ITERS // 2
    launches = {"blend_fwd": {}, "blend_bwd": {}}
    loop_errs, legs = {}, []
    for leg, extra in ((1, ["--leg_until", str(half)]), (2, ["--resume"])):
        phase = f"46 leg {leg}"
        torch.cuda.synchronize()
        blend_fwd.launches = blend_bwd.launches = 0
        with LoopBlends() as cap:
            out = longrun.main(argv + extra)
        torch.cuda.synchronize()
        got = (blend_fwd.launches, blend_bwd.launches)
        launches["blend_fwd"][phase], launches["blend_bwd"][phase] = got
        if got != (half + LONGRUN_EVAL_FRAMES, half):
            raise AssertionError(f"phase {phase}: blend launches {got}")
        legs.append(out["legs"][-1])
        loop_errs[phase] = check_loop_blends(f"phase {phase}", cap)
        del cap
    first, second = legs
    with open(os.path.join(run, "train_state", f"iteration_{half}",
                           "meta.json")) as f:
        saved = json.load(f)
    joins = {
        "resumed at": (second["from"], half + 1),
        "view order": (second["view_rng_start"], first["view_rng_end"]),
        "view order saved": (longrun.digest(saved["view_rng"]),
                             first["view_rng_end"]),
        "dup_factor": (second["dup_factor_start"], first["dup_factor_end"]),
        "dup_factor saved": (saved["dup_factor"], first["dup_factor_end"]),
        "densify passes": ((first["densify_passes"],
                            second["densify_passes"]), (1, 1)),
        "evaluations": ([t["iter"] for t in out["trajectory"]],
                        [half, LONGRUN_ITERS])}
    for what, (a, b) in joins.items():
        if a != b:
            raise AssertionError(f"phase 46: the legs do not join: {what} "
                                 f"{a} against {b}")
    if not (out["done"] and math.isfinite(out["final_psnr_db"])
            and out["final_points"] > 0 and out["dup_factor"] >= 64):
        raise AssertionError(f"phase 46: {json.dumps(out)[:2000]}")
    psnr = {t["iter"]: t["psnr_db"] for t in out["trajectory"]}
    print(f"phase 46: scripts/longrun_torch.py at "
          f"{out['protocol']['resolution']}, {out['protocol']['init_pts']} "
          f"hull points, dup_factor {first['dup_factor_start']} -> "
          f"{out['dup_factor']}, {LONGRUN_ITERS} iterations in two legs "
          f"({first['ms_per_it']:.3f} and {second['ms_per_it']:.3f} ms/it, "
          f"steps {first['step_ms']:.3f} and {second['step_ms']:.3f} ms); "
          f"resumed at {second['from']} with the saved view order and "
          f"dup_factor; test PSNR {psnr}; {out['final_points']} splats, "
          f"capacity {out['capacity']}; blend launches {launches}; "
          f"{time.time() - t_phase:.1f} s; {smi}")
    return launches, loop_errs


GATE_STEP_VIEW = 3        # phase 47's view: frame 3 of the gate's 6 (fid 0.6)
GATE_STEP_SEED = 42       # the JAX gate's default scene seed


def _script(name):
    """``scripts/<name>.py`` as a module."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gate_step_phase(dev, smi):
    """Phase 47: one step of the 4-D quality gate's regime on the card
    against the CPU from the same state: the ``owlii4d`` scene and trainee
    of ``scripts/quality_gate_torch.py``'s ``Gate``, which the gate and
    ``scripts/gate_parity_cpu.py`` build from too, at full size (400x400,
    3,000 true Gaussians, 20,000 splats, VarTriPlane at its default 20x20
    noise, 6 frames, ResField rank 40, offset flow; ``tile_cap`` 1024 and the
    default ``dup_factor`` 5, a 100,000-row budget the untrained field
    overflows), one view at frame 3. The splats, the net and Adam states
    with non-zero moments (``nonzero_adam``) are made on the CPU and copied
    to the card, so both devices start bit for bit alike. Both steps must
    drop the same instance count, above 0; the step is held as phase 7's
    (``check_small_step``), and both blend kernels against their plain
    versions on the card step's own inputs (``check_loop_blends``).
    Returns ({kernel name: {phase: launches}}, {phase: errors})."""
    import copy
    import time

    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd

    t_phase = time.time()
    qg = _script("quality_gate_torch")
    cpu = torch.device("cpu")
    gate = qg.Gate("owlii4d", GATE_STEP_SEED, dev)
    fid = gate.cams[GATE_STEP_VIEW].fid
    params, stats, _, deform = gate.trainee(cpu)
    fparams = {k: v.detach() for k, v in deform.params.items()}
    start = (params, stats, nonzero_adam(params, 1), fparams,
             nonzero_adam(fparams, 2))

    def on(device, tree):
        if isinstance(tree, dict):
            return {k: v.to(device) for k, v in tree.items()}
        if isinstance(tree, splats.AdamState):
            return splats.AdamState(count=tree.count, mu=on(device, tree.mu),
                                    nu=on(device, tree.nu))
        if isinstance(tree, splats.SplatStats):
            return splats.SplatStats(**{
                f.name: getattr(tree, f.name).to(device)
                for f in dataclasses.fields(tree)})
        return splats.tree_like(tree, on(device, splats.tree_items(tree)))

    res, launches = {}, {"blend_fwd": {}, "blend_bwd": {}}
    for name, device, net in (("cuda", dev, copy.deepcopy(deform.net).to(
            dev)), ("cpu", cpu, deform.net)):
        args = (*[on(device, t) for t in start],
                gate.batch([GATE_STEP_VIEW], device),
                splats.splat_lr_tree(*qg.SPLAT_LRS), qg.FIELD_LR)
        step = gate.train_step(net)
        if name == "cuda":
            torch.cuda.synchronize()
            blend_fwd.launches = blend_bwd.launches = 0
            with LoopBlends() as cap:
                res[name] = step(*args)
            torch.cuda.synchronize()
            got = (blend_fwd.launches, blend_bwd.launches)
            launches["blend_fwd"]["47"], launches["blend_bwd"]["47"] = got
            if got != (1, 1):
                raise AssertionError(f"phase 47: blend launches {got}")
        else:
            res[name] = step(*args)
    dropped = {k: int(v[5].loss_dict["bin_dropped"]) for k, v in res.items()}
    print(f"phase 47: the 4-D gate's step (owlii4d, {gate.res}x{gate.res}, "
          f"{gate.n_splats} splats, dup_factor {gate.pipe.dup_factor}, frame "
          f"{round(fid * (gate.n_frames - 1))}), card against CPU: dropped "
          f"{dropped}")
    if not (dropped["cuda"] == dropped["cpu"] > 0):
        raise AssertionError(f"phase 47: dropped instances {dropped}")
    check_small_step(res["cuda"], res["cpu"])
    errs = {"47": check_loop_blends("phase 47", cap)}
    del res, cap
    torch.cuda.empty_cache()
    print(f"phase 47: blend launches {launches}, {time.time() - t_phase:.1f}"
          f" s; {smi}")
    return launches, errs


class F32Mains:
    """Every call of ``train.main``, ``render.main`` and
    ``extract_geo.main`` while entered starts with TF32 turned on and must
    return with both flags off: the CLIs keep their math f32 on their own
    (``device.full_f32_math``). ``calls`` counts the mains checked."""

    def __enter__(self):
        import torch

        from splatfields_torch import extract_geo, render, train
        self.calls, self.saved = 0, []
        for mod in (train, render, extract_geo):
            self.saved.append((mod, mod.main))
            mod.main = self._checked(mod.__name__, mod.main, torch)
        return self

    def _checked(self, name, fn, torch):
        def run(*args, **kw):
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            out = fn(*args, **kw)
            if (torch.backends.cudnn.allow_tf32
                    or torch.backends.cuda.matmul.allow_tf32):
                raise AssertionError(f"{name}.main left TF32 on")
            self.calls += 1
            return out
        return run

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod.main = fn


def main() -> int:
    import time

    import torch
    t_phase = [time.time()]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "SPLATFIELDS_FUSED_MLP" in os.environ:
        # it would override every phase's choice of head path
        print("chip_smoke: unset SPLATFIELDS_FUSED_MLP", file=sys.stderr)
        return 1
    # the reference numbers are f32: keep cuDNN convs and matmuls off TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # and the JAX package's bf16 defaults off (on for CUDA tensors under
    # "auto"): every check before phase 40 is f32; phases 40-41 turn them
    # on for their own runs
    os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    os.environ["SPLATFIELDS_NGP_BF16_TABLE"] = "off"

    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.raster import blend_cuda
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
    from concurrent.futures import ThreadPoolExecutor

    from splatfields_torch import native
    with ThreadPoolExecutor(1) as pool:   # g++ beside nvcc
        host_libs = pool.submit(lambda: [native.library(n, {})
                                         for n in NATIVE_LIBS])
        for name, (lib_path, build_s) in blend_cuda.build().items():
            print(f"{name} built in {build_s:.2f} s: {lib_path.name}")
            log = lib_path.with_suffix(".log")
            if log.exists():
                print(log.read_text().strip())
        host_libs.result()

    # --- 2. kernel vs plain at the serving shape ---------------------------
    sc = serving_scene()
    params, stats, deform, pipe, bg, cams = (
        sc.params, sc.stats, sc.deform, sc.pipe, sc.bg, sc.cams)

    # the blend's inputs exactly as the serving path hands them over
    args = serving_blend_args(sc)
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
    for kind in BLEND_KINDS:
        (pack_, start_, counts_, ids_), tx, ty = blend_case(kind, dev)
        args_ = (pack_, start_, counts_, tx, ty, 16, 1024, 128, ids_)
        check_close(f"{kind} case", blend_fwd(*args_),
                    blend_sorted_plain(*args_))
        print(f"{kind} case work: "
              f"{blend_work(*args_[:3], tx, 16, 1024, 128, ids_)}")

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
    graph_kernel_ms = graph_ms(lambda: blend_fwd(*args), 50)
    plain_ms = cuda_ms(lambda: blend_sorted_plain(*args), 5)
    work = blend_work(sorted_pack, tile_start, counts, args[3], 16, 1024,
                      128)
    evaluated, applied = work.evaluated, work.applied
    n_tiles, p = counts.shape[0], 16 * 16
    bytes_moved = (sorted_pack.numel() * 4 + (tile_start.numel()
                   + 2 * n_tiles) * 4 + n_tiles * 5 * p * 4)
    ops = OPS_EVALUATED * evaluated + OPS_APPLIED * applied
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    print(f"render ms/frame {frame_ms:.4f} ({RES}x{RES}, {N_SPLATS} splats)")
    print(f"blend work: {evaluated} pairs evaluated, {applied} applied, "
          f"{work.warp_rows} warp-rows with an applied lane, {work.culled} "
          f"of {int(counts.clamp(max=1024).sum())} tile rows culled; "
          f"{bytes_moved} bytes; bytes bound {bytes_ms:.5f} ms, ops bound "
          f"{ops_ms:.5f} ms")
    print(f"blend_fwd: kernel {kernel_ms:.5f} ms, graph replay "
          f"{graph_kernel_ms:.5f} ms, plain {plain_ms:.4f} ms; {smi}")

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

    def took(phases):
        torch.cuda.synchronize()
        print(f"phases {phases}: {time.time() - t_phase[0]:.1f} s")
        t_phase[0] = time.time()

    took("1-4")
    # --- 5-7. the training slice -------------------------------------------
    bwd_entry = train_phases(sc, dev, smi)
    took("5-7")
    # --- 8-10. the NGP training slice ----------------------------------------
    segsum_entry = ngp_phases(sc, dev, smi)
    took("8-10")
    # --- 11-13. the fused heads ----------------------------------------------
    fused_entries = fused_phases(sc, dev, smi)
    del sc, params, stats, deform
    torch.cuda.empty_cache()
    took("11-13")
    # every CLI call from here on must leave TF32 off by itself
    f32_mains = F32Mains().__enter__()
    # every render line's video.gif, for phase 38
    video_log = VideoLog().__enter__()
    # --- 14-17. the Blender protocol through the CLIs ---------------------------
    loop_launches, loop_errs = protocol_phases(dev, smi)
    torch.cuda.empty_cache()
    took("14-17")
    # --- 18-22. the Moran line, extract_geo, run_dtu.sh, LPIPS ---------------
    static_launches, static_errs, partial_errs = static_phases(dev, smi)
    torch.cuda.empty_cache()
    took("18-22")
    # --- 23-26. the Owlii 4-D protocol -------------------------------------
    owlii_launches, owlii_errs = owlii_phases(dev, smi)
    torch.cuda.empty_cache()
    took("23-26")
    # --- 27-31. the train CLI's field options ----------------------------------
    (option_launches, option_errs, fused_launches,
     fused_gaps) = option_phases(dev, smi)
    torch.cuda.empty_cache()
    took("27-31")
    # --- 32-35. the Colmap and nerfies datasets, --profile, --watchdog_min --
    dataset_launches, dataset_errs, dataset_partial = dataset_phases(dev, smi)
    took("32-35")
    # --- 36-39. the carver, a JPEG capture, the videos, the ResField zoo ----
    (tail_launches, zoo_segsum_errs, tail_errs,
     tail_partial) = host_tail_phases(dev, smi, video_log)
    video_log.__exit__(None, None, None)
    took("36-39")
    # --- 40-41. the bf16 defaults, off and on ---------------------------------
    bf16_launches, bf16_segsum_err = bf16_phases(dev, smi)
    took("40-41")
    # --- 42. multi-device on one card -------------------------------------------
    mesh_launches = mesh_phases(dev, smi)
    took("42")
    # --- 43-44. the off-by-default field options ------------------------------
    plane_entry, plane_launches = plane_phases(dev, smi)
    took("43-44")
    # --- 46. the long run in legs -------------------------------------------
    longrun_launches, longrun_errs = longrun_phase(dev, smi)
    took("46")
    # --- 47. the 4-D quality gate's step, card against CPU ---------------
    gate_launches, gate_errs = gate_step_phase(dev, smi)
    took("47")
    f32_mains.__exit__(None, None, None)
    print(f"TF32 off after each of {f32_mains.calls} CLI mains (each "
          "started with TF32 on)")
    for k in loop_launches:
        loop_launches[k].update(static_launches[k])
        loop_launches[k].update(owlii_launches[k])
        loop_launches[k].update(option_launches[k])
        loop_launches[k].update(dataset_launches[k])
        loop_launches[k].update(tail_launches[k])
        loop_launches[k].update(bf16_launches[k])
        loop_launches[k].update(mesh_launches[k])
        loop_launches[k].update(plane_launches[k])
        loop_launches[k].update(longrun_launches[k])
        loop_launches[k].update(gate_launches[k])
    segsum_entry["zoo_launches"] = tail_launches["segsum"]
    segsum_entry["zoo_max_abs_err"] = max(zoo_segsum_errs)
    segsum_entry["bf16_table_launches"] = bf16_launches["segsum"]
    segsum_entry["bf16_table_max_abs_err"] = bf16_segsum_err
    # phase 43: the plane gradient's rows; phase 44: its launches there
    segsum_entry.update(plane_entry)
    segsum_entry["plane_grad_launches"] = plane_launches["segsum"]
    loop_errs.update(static_errs)
    loop_errs.update(owlii_errs)
    loop_errs.update(option_errs)
    loop_errs.update(dataset_errs)
    loop_errs.update(tail_errs)
    loop_errs.update(longrun_errs)
    loop_errs.update(gate_errs)
    partial_errs.update(dataset_partial)
    partial_errs.update(tail_partial)
    for entry in fused_entries:
        # phase 28: the new plans' launches and worst layer gap
        entry["option_launches"] = fused_launches[entry["name"]]
        entry["option_max_layer_gap"] = fused_gaps
    bwd_entry["loop_launches"] = loop_launches["blend_bwd"]
    bwd_entry["loop_max_abs_err"] = {
        ph: e["step backward"] for ph, e in loop_errs.items()}
    bwd_entry["partial_tile_max_err"] = {
        ph: e["backward"] for ph, e in partial_errs.items()}

    kernels = [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "splatfields_torch/csrc/blend_fwd.cu",
        "replaces": "splatfields_tpu/ops/raster/blend_pallas.py:226",
        "launches": launches,
        "max_abs_err": serving_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "graph_ms": graph_kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
        "loop_launches": loop_launches["blend_fwd"],
        "loop_max_abs_err": {ph: {k: e[k] for k in ("step", "evaluation frame")
                                  if k in e}
                             for ph, e in loop_errs.items()},
        "partial_tile_max_abs_err": {
            ph: {k: e[k] for k in TOL} for ph, e in partial_errs.items()},
    }, bwd_entry, segsum_entry, *fused_entries]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
