"""Where the tile-blend kernels' time goes, on a GPU.

    python3 scripts/profile_blend.py [--parent DIR]

Times ``blend_fwd`` on chip_smoke.py's phase-2 inputs (serving frame 0 of
the 100k-splat 800x800 scene) and ``blend_bwd`` on its phase-5 inputs (one
training step's blend backward), each as the whole kernel and as
timing-only variants built from rewritten copies of the sources (into
``build/profile_blend/``; ``csrc/`` itself has no switches):

- "no expf": the full-precision ``expf`` replaced by ``__expf`` (one
  MUFU.EX2 and a multiply), so what it saves is the expf's cost beyond the
  hardware exp, with the same skip decisions up to an ulp of alpha;
- "no partials" (backward): the ten per-pair partials all set to ``w``,
  which the replay computes anyway, so the partials' arithmetic (and the
  dL/dalpha that only they use) is gone and the row sums stay;
- "no reduction" (backward): the per-row warp sums (the parent's shuffle
  trees; the new design's reduce-scatter, for which each lane adds its own
  ten partials, nine adds, so that all ten stay live) left out, each
  lane's own value standing for the warp's;
- "staging only": the pixel loop left out, so each tile stages all its
  rows (and the backward writes its row sums) and nothing else;
- "fast division" (new backward): its two IEEE divisions, the plain
  version's, as ``__fdividef`` (2 ulp): what exact division costs.

It also times the heaviest tile (most rows) alone against the whole
launch (the tail a launch cannot go below), the whole launch with the
tiles permuted heaviest first (the same work; outputs in that order), and
the one argsort of the counts such an order would cost. ``--parent DIR`` (another
checkout, e.g. the parent commit unpacked by ``git archive`` under
``build/``) adds the parent's sources: the whole kernels then run in turns
parent, change, change, parent on the same inputs in one process, then
every variant of both. Variants' outputs are wrong by design. Prints the
card's name and power limit, each time, the work (``blend_work``) and a
JSON line of the times. Needs a CUDA card and nvcc; exits 1 without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (old, new, count) text rewrites per design ("parent": the one-thread-a-
# pixel kernels with scalar staging and shuffle trees; "rows": the kernels
# on csrc/blend_rows.cuh), kernel and variant. A rewrite whose text is not
# found the given number of times stops the script.
FWD, BWD = "blend_fwd", "blend_bwd"
NO_EXPF = [("expf(power)", "__expf(power)", 1)]
PARTIALS_RE = (re.compile(r"( *)v\[0\] = [^\n]*\n(?: *v\[\d\] = [^\n]*\n){9}"),
               r"\1for (int k = 0; k < kAttrs; ++k) v[k] = w;\n", 1)
RULES = {
    "parent": {
        FWD: {"no expf": NO_EXPF,
              "staging only": [("for (int j = 0; j < m && !done; ++j) {",
                                "for (int j = 0; j < 0; ++j) {", 1)]},
        BWD: {"no expf": NO_EXPF,
              "no partials": [PARTIALS_RE],
              "no reduction": [(
                  "v[k] += __shfl_down_sync(kFullMask, v[k], off);", ";",
                  1)],
              "staging only": [(
                  "for (int j = 0; j < m; ++j) {  // m is uniform: every "
                  "lane takes part", "for (int j = 0; j < 0; ++j) {", 1)]},
    },
    "rows": {
        FWD: {"no expf": NO_EXPF,
              "staging only": [("for (int j = 0; j < m && !done; ++j) {",
                                "for (int j = 0; j < 0; ++j) {", 1)]},
        BWD: {"no expf": NO_EXPF,
              "no partials": [PARTIALS_RE],
              "no reduction": [(
                  "const float sum = warp_sum_scatter(v, lane);",
                  "float sum = 0.0f;\n"
                  "          for (int k = 0; k < kAttrs; ++k) sum += v[k];",
                  1)],
              "staging only": [("for (; j < mm; ++j) {",
                                "for (; j < 0; ++j) {", 1)],
              "fast division": [
                  ("((tot_c - pre_c) + (tot_d - pre_d) + tf_gt) /\n"
                   "                        fmaxf(1.0f - alpha, 1e-6f)",
                   "__fdividef((tot_c - pre_c) + (tot_d - pre_d) + tf_gt, "
                   "fmaxf(1.0f - alpha, 1e-6f))", 1),
                  ("ga / fmaxf(q.z, 1e-9f)",
                   "__fdividef(ga, fmaxf(q.z, 1e-9f))", 1)]},
    },
}


def design_of(csrc: pathlib.Path) -> str:
    return ("rows" if "blend_rows.cuh" in (csrc / "blend_fwd.cu").read_text()
            else "parent")


def rewrite(src: str, rules) -> str:
    for old, new, count in rules:
        if isinstance(old, re.Pattern):
            src, n = old.subn(new, src)
        else:
            n = src.count(old)
            src = src.replace(old, new)
        if n != count:
            raise RuntimeError(f"rewrite {old!r}: {n} matches, not {count}")
    return src


def build_variants(designs, out_dir):
    """Compile every (design, kernel, variant) at once; returns
    ``{(design label, kernel, variant): library path}``."""
    from splatfields_torch.ops import cuda_build
    jobs = {}
    for label, csrc in designs:
        rules = RULES[design_of(csrc)]
        for kernel in (FWD, BWD):
            for variant in ["full", *rules[kernel]]:
                tag = f"{label}_{kernel}_{variant.replace(' ', '_')}"
                src = out_dir / f"{tag}.cu"
                text = (csrc / f"{kernel}.cu").read_text()
                src.write_text(text if variant == "full" else
                               rewrite(text, rules[kernel][variant]))
                lib = out_dir / f"lib{tag}.so"
                jobs[(label, kernel, variant)] = (lib, subprocess.Popen(
                    [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                     str(csrc), "-o", str(lib), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{report}")
        regs = re.findall(r"Used (\d+) registers", report)
        print(f"built {key}: registers {regs}")
        libs[key] = lib
    return libs


def warp_box_cover(pack, tile_start, counts, tiles_x, ts, tile_cap):
    """Over the (tile, row) pairs the tile cull keeps: the mean number of
    the tile's warps (32 consecutive pixels, ``ts * ts / 32`` strips of
    ``32 / ts`` pixel rows) that the row's cull box (``tile_cull``'s
    half-widths at the pre-test level) reaches: what a per-warp box test
    could still skip."""
    import torch

    from splatfields_torch.ops.raster import blend_torch as bt
    n = counts.clamp(min=0, max=tile_cap).long()
    tile = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device),
                                   n)
    first = torch.repeat_interleave(tile_start[:-1].long(), n)
    idx = first + torch.arange(tile.shape[0], device=n.device) - \
        torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rows = pack[idx]
    x0 = (tile % tiles_x).float() * ts
    y0 = (tile // tiles_x).float() * ts
    thr = bt.row_threshold(rows[:, 5])
    kept = ~bt.tile_cull(rows, thr, x0, y0, ts)
    a, b, c = rows[:, 2], rows[:, 3], rows[:, 4]
    hy = torch.sqrt(-2 * thr * a / (a * c - b * b))
    lines = 32 // ts
    cover = torch.zeros_like(hy)
    for w in range(ts * ts // 32):
        lo = y0 + w * lines
        hit = (rows[:, 1] + hy >= lo) & (rows[:, 1] - hy <= lo + lines - 1)
        cover += (hit | ~torch.isfinite(hy)).float()
    return float(cover[kept].mean()), int(kept.sum())


def launcher(kernel, lib_path, a):
    """A no-argument launch of ``kernel`` from ``lib_path`` (its C
    signature: ``cuda_build.KERNELS``) on phase 2's forward or phase 5's
    backward arguments ``a``, outputs allocated once."""
    import torch

    from splatfields_torch.ops import cuda_build
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = cuda_build.KERNELS[kernel][1]
    fn.restype = ctypes.c_int
    pack, tile_start, counts, tile_ids = a[:4]
    n_tiles, dev = counts.shape[0], pack.device
    if kernel == FWD:
        tiles_x, ts, cap = a[4:7]
        p = ts * ts
        outs = [torch.empty(n_tiles, 3, p, device=dev),
                torch.empty(n_tiles, p, device=dev),
                torch.empty(n_tiles, p, device=dev)]
    else:
        tiles_x, ts, cap = a[10:13]
        outs = [*a[4:10], torch.zeros(pack.shape[0], 10, device=dev)]
    args = [pack, pack.shape[0], tile_start, counts, tile_ids, *outs,
            n_tiles, tiles_x, ts, cap]
    ptrs = [x if isinstance(x, int) else x.data_ptr() for x in args]

    def go():
        err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kernel} launch failed: {err}")
    go.tensors = args   # the pointers' tensors live as long as the launch
    return go


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent design")
    ap.add_argument("--iters", type=int, default=50)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_blend: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster.blend_torch import blend_work
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    designs = [("change", ROOT / "splatfields_torch" / "csrc")]
    if opts.parent:
        designs.append(("parent", pathlib.Path(opts.parent).resolve()
                        / "splatfields_torch" / "csrc"))
    out_dir = ROOT / "build" / "profile_blend"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_variants(designs, out_dir)

    dev = torch.device("cuda")
    sc = cs.serving_scene(dev)
    fargs = cs.serving_blend_args(sc)
    pack, tile_start, counts, tiles_x, _, ts, tile_cap, k_chunk = fargs
    tile_ids = torch.arange(counts.shape[0], device=dev, dtype=torch.int32)
    fwd_in = (pack, tile_start, counts, tile_ids, tiles_x, ts, tile_cap)
    step = cs.train_step_fn(sc.deform, sc.pipe, cs.RES)
    lrs = splats.splat_lr_tree(*cs.SPLAT_LRS)
    bargs = cs.training_blend_args(sc, step, cs.training_batches(dev)[-1],
                                   lrs)
    del sc, step
    torch.cuda.synchronize()
    for name, a in (("serving frame 0", fwd_in), ("training frame", bargs)):
        w = blend_work(a[0], a[1], a[2], tiles_x, ts, tile_cap, k_chunk,
                       a[3])
        n = a[2].clamp(max=tile_cap)
        cover, kept = warp_box_cover(a[0], a[1], a[2], tiles_x, ts, tile_cap)
        print(f"{name}: pack {tuple(a[0].shape)}, {a[2].shape[0]} tiles, "
              f"rows a tile mean {float(n.float().mean()):.1f} max "
              f"{int(n.max())}; {w}; {kept} kept rows' boxes reach "
              f"{cover:.3f} of a tile's {ts * ts // 32} warps")

    def heaviest(a, fields):
        """The arguments of the tile with the most rows alone."""
        t = int(a[2].clamp(max=tile_cap).argmax())
        one = list(a)
        one[1] = a[1][t:t + 2].contiguous()
        for i in (2, 3, *fields):
            one[i] = a[i][t:t + 1].contiguous()
        return tuple(one), int(a[2][t])

    def heavy_first(a, fields):
        """The arguments with the tiles permuted, most rows first: the same
        work, each CTA on its own tile's data, outputs in that order."""
        order = torch.argsort(a[2].clamp(max=tile_cap), descending=True,
                              stable=True)
        out = list(a)
        out[1] = torch.cat([a[1][:-1][order], a[1][-1:]])
        for i in (2, 3, *fields):
            out[i] = a[i][order].contiguous()
        return tuple(out)

    fwd_one, fwd_rows = heaviest(fwd_in, ())
    bwd_one, bwd_rows = heaviest(bargs, range(4, 10))
    inputs = {FWD: (fwd_in, fwd_one, heavy_first(fwd_in, ())),
              BWD: (bargs, bwd_one, heavy_first(bargs, range(4, 10)))}
    which_name = ("", " heaviest tile", " tiles heavy first")
    times = {}

    def timed(label, kernel, variant, which=0):
        go = launcher(kernel, libs[(label, kernel, variant)],
                      inputs[kernel][which])
        ms = cs.graph_ms(go, opts.iters)
        key = f"{label} {kernel} {variant}{which_name[which]}"
        times.setdefault(key, []).append(ms)
        line = f"{key}: {ms:.5f} ms (graph replay)"
        if variant == "full" and not which:
            eager = cs.cuda_ms(go, opts.iters)
            times.setdefault(key + " eager", []).append(eager)
            line += f", {eager:.5f} ms eager"
        print(line)

    labels = [d[0] for d in designs]
    turns = ["parent", "change", "change", "parent"] if opts.parent else \
        ["change", "change"]
    for label in turns:
        for kernel in (FWD, BWD):
            timed(label, kernel, "full")
    for label in labels:
        for kernel in (FWD, BWD):
            for variant in sorted(v for (lb, k, v) in libs
                                  if lb == label and k == kernel):
                if variant != "full":
                    timed(label, kernel, variant)
            timed(label, kernel, "full", which=1)
            timed(label, kernel, "full", which=2)
    # what launching heavy tiles first would cost: one argsort of the counts
    sort_ms = cs.graph_ms(lambda: torch.argsort(
        counts.clamp(max=tile_cap), descending=True, stable=True).to(
            torch.int32), opts.iters)
    times["argsort of the counts"] = [sort_ms]
    print(f"argsort of the {counts.shape[0]} counts: {sort_ms:.5f} ms "
          "(graph replay)")
    print(f"heaviest tile rows: forward {fwd_rows}, backward {bwd_rows}")
    print(json.dumps({"device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
