"""Peak device memory of the fused training step and of the fused
backward alone, for the checkout at ``--root`` (default: this one), so two
checkouts compare in one call:

    python3 scripts/fused_step_memory.py [--root DIR] [--steps 3]

The step is chip_smoke.py's phase-12 step (bench.py's default workload,
100,000 splats, 800x800, one view, the heads through the fused kernels in
bf16), built with the helpers of the ``chip_smoke.py`` under ``--root``.
The backward alone is one ``fused_heads_bwd`` of each plan on the inputs
the last step gave it. Prints one JSON line: the card's name and power
limit, the bytes allocated before, and ``torch.cuda.max_memory_allocated``
over the steps and over the backward. Needs a CUDA card; exits 1 without
one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke as cs
    from splatfields_torch.models import splats
    from splatfields_torch.ops import fused_mlp as fm

    dev = torch.device("cuda")
    sc = cs.serving_scene(dev)
    sc.deform.net.fused_pallas = "on"
    step = cs.train_step_fn(sc.deform, sc.pipe, cs.RES)
    lrs = splats.splat_lr_tree(*cs.SPLAT_LRS)
    rng = np.random.RandomState(0)
    batches = [cs.train_batch(c, rng, dev)
               for c in cs.make_views(args.steps, cs.RES)]
    captured, bwd = [], fm.fused_heads_bwd

    def spy(*a):
        captured.append(a)
        return bwd(*a)

    spy.launches = 0
    state = (sc.params, sc.stats, splats.adam_init(sc.params),
             sc.deform.params, sc.deform.opt_state)
    torch.cuda.synchronize()
    step_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fm.fused_heads_bwd = spy
    try:
        for b in batches:
            captured.clear()
            *state, _ = step(*state, b, lrs, cs.FIELD_LR)
    finally:
        fm.fused_heads_bwd = bwd
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    del state, batches
    bwd_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for a in captured:
        bwd(*a)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "root": args.root, "card": smi.strip().splitlines()[0],
        "steps": args.steps, "step_base_bytes": step_base,
        "step_peak_bytes": step_peak, "bwd_plans": len(captured),
        "bwd_base_bytes": bwd_base, "bwd_peak_bytes": bwd_peak,
        "bwd_extra_bytes": bwd_peak - bwd_base}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
