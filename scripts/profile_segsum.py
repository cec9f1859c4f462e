"""Where the segment-sum kernel's time goes, and the table VJP around it,
on a GPU.

    python3 scripts/profile_segsum.py [--parent DIR] [--iters N]

Captures chip_smoke.py's phase-8 inputs (the sorted ids and gradient rows
of one full-width ``bench.py --variant ngp`` training step, 12.8M slots
into 2^24 rows, D = 2, and the unsorted ids and rows ``_sort_rows`` got)
and times, in CUDA-graph replay and eagerly:

- the kernel alone on buffers allocated once, and each design's wrapper
  call (the change's: one launch into a new output; the parent's: its
  edges' ``arange``, multiply, ``clamp_max`` and ``searchsorted`` first),
  in turns parent, change, change, parent with ``--parent DIR`` (another
  checkout, e.g. the parent commit unpacked by ``git archive`` under
  ``build/``);
- timing-only variants built from rewritten copies of the sources (into
  ``build/profile_segsum/``; ``csrc/`` itself has no switches): "edge
  search" (the launch's first phase alone, every block edge found, no
  sums; the parent's counterpart is its ``searchsorted`` over the block
  edges, timed as a call), "staging only" (the slots loaded, the row
  image zeroed and stored, no sums; its output is wrong by design),
  "phase 2 alone" (the edges given from ``block_ranges``, no search and
  no grid barrier), "no prefetch" (each step's loads issued at its own
  start) and "64 registers" (``__launch_bounds__`` for four blocks an
  SM); the last three are checked against the plain version;
- the heaviest block alone (most rows plus slots; the parent: most slots)
  against the whole launch: the tail a launch cannot go below;
- the change's kernel at other merge-path items a block;
- beside it, ``index_add_`` (the library call for the same sums) and
  ``_sort_rows``'s stable ``torch.sort`` and ``index_select``, so that
  the table VJP is accounted for whole.

Prints the card's name and power limit, each time, and a JSON line of the
times. Needs a CUDA card and nvcc; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (old, new, count) text rewrites of each design's source, per variant. A
# rewrite whose text is not found the given number of times stops the
# script. "merge": csrc/segsum.cu's merge-path blocks; "rows": the parent's
# thread a row with its block edges from a searchsorted.
RULES = {
    "merge": {
        "edge search": [("cooperative_groups::this_grid().sync();",
                         "return;", 1)],
        # the edges given (block_ranges on the host): no search, no barrier
        "phase 2 alone": [
            ("       e <= n_blocks; e += 2 * n_warps) {",
             "       e < 0; e += 2 * n_warps) {", 1),
            ("cooperative_groups::this_grid().sync();", "", 1)],
        "no prefetch": [
            ("    Group<W> cur, nxt;\n    if (a < s1) {\n"
             "      load_group<W, kMode>(cur, sidx, vals, a + kSlots * tid, "
             "s1, d, c0, lane);\n    }\n", "    Group<W> cur;\n", 1),
            ("      if (t0 + kStep < s1) {\n"
             "        load_group<W, kMode>(nxt, sidx, vals, t0 + kStep + "
             "kSlots * tid, s1,\n                             d, c0, lane);"
             "\n      }\n",
             "      load_group<W, kMode>(cur, sidx, vals, t0 + kSlots * tid, "
             "s1, d, c0, lane);\n", 1),
            ("      cur = nxt;\n", "", 1)],
        # at most 64 registers a thread: four blocks an SM by registers
        "64 registers": [("__global__ void __launch_bounds__(kThreads)\n"
                          "segsum_kernel(",
                          "__global__ void __launch_bounds__(kThreads, 4)\n"
                          "segsum_kernel(", 1)],
        "staging only": [(re.compile(
            r"step_sums<W>\(cur, carry, buf, off, r0, r1, agg_v\[parity\],"
            r"\s*agg_f\[parity\], lane, warp\);"),
            "{\n        float t = 0.0f;\n        int x = cur.key[0] ^ cur.key[1]"
            " ^ cur.key[2] ^ cur.key[3];\n"
            "        for (int q = 0; q < kSlots; ++q)\n"
            "          for (int w = 0; w < W; ++w) t += cur.val[q][w];\n"
            "        if (x == 12345 && t == 0.5f) buf[0] = t;\n      }", 1)],
    },
    "rows": {},
}


def design_of(csrc: pathlib.Path) -> str:
    return ("rows" if "const int* bounds" in (csrc / "segsum.cu").read_text()
            else "merge")


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
    """Compile every (design, variant) at once; returns ``{(label,
    variant): library path}``."""
    from splatfields_torch.ops import cuda_build
    jobs = {}
    for label, csrc in designs:
        rules = RULES[design_of(csrc)]
        for variant in ["full", *rules]:
            tag = f"{label}_{variant.replace(' ', '_')}"
            src = out_dir / f"{tag}.cu"
            text = (csrc / "segsum.cu").read_text()
            src.write_text(text if variant == "full" else
                           rewrite(text, rules[variant]))
            lib = out_dir / f"lib{tag}.so"
            jobs[(label, variant)] = (lib, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
                 "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{report}")
        regs = re.findall(r"Used (\d+) registers", report)
        print(f"built {key}: registers {regs}")
        libs[key] = lib
    return libs


def launcher(design, lib_path, sidx, vals, n_rows, items=None, out=None,
             given_edges=False):
    """A no-argument launch of the segment sum from ``lib_path`` on
    ``sidx``, ``vals``: ``go()`` the kernel alone into ``out`` (allocated
    once; the parent's block edges computed once), ``go.call()`` what the
    design's wrapper does (a new output; the parent's edges first). With
    ``given_edges`` the scratch holds ``block_ranges``'s edges."""
    import torch
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.segsum_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    m, d = vals.shape
    dev = vals.device
    if out is None:
        out = torch.empty(n_rows, d, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"segsum launch failed: {err}")

    if design == "merge":
        from splatfields_torch.ops.segsum import items_per_block
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        items = items or items_per_block(d)
        n_edges = 2 * (-(-(n_rows + m) // items) + 1)
        scratch = torch.empty(n_edges, dtype=torch.int32, device=dev)
        if given_edges:
            from splatfields_torch.ops.segsum import block_ranges
            r0, r1, s0, s1 = block_ranges(sidx, n_rows, items)
            scratch = torch.stack([torch.cat([r0, r1[-1:]]),
                                   torch.cat([s0, s1[-1:]])], 1).reshape(
                                       -1).to(torch.int32).contiguous()

        def launch(o, e=scratch):
            check(fn(sidx.data_ptr(), vals.data_ptr(), o.data_ptr(),
                     e.data_ptr(), m, n_rows, d, items, stream()))

        def call():
            o = torch.empty(n_rows, d, device=dev)
            launch(o, torch.empty(n_edges, dtype=torch.int32, device=dev))
            return o
    else:
        fn.argtypes = [p, p, p, p, i, i, p]
        rows_per_block = 256

        def edges():
            n_blocks = -(-n_rows // rows_per_block)
            e = torch.clamp_max(torch.arange(
                n_blocks + 1, dtype=torch.int32, device=dev)
                * rows_per_block, n_rows)
            return torch.searchsorted(sidx, e, out_int32=True)

        bounds = edges()

        def launch(o, b=bounds):
            check(fn(sidx.data_ptr(), vals.data_ptr(), b.data_ptr(),
                     o.data_ptr(), n_rows, d, stream()))

        def call():
            o = torch.empty(n_rows, d, device=dev)
            launch(o, edges())
            return o
        launch.edges = edges

    def go():
        launch(out)
    go.call, go.out, go.launch = call, out, launch
    go.tensors = (sidx, vals)   # the pointers' tensors live with the launch
    return go


def heaviest_block(design, sidx, vals, n_rows, d):
    """The inputs of the design's heaviest block alone, as a problem of
    its own: ``(sidx, vals, n_rows, items, what)``. Merge path: the block
    with the most rows plus slots, its slots from the 4-aligned slot
    before its first (so the loads stay aligned; the ids before its rows
    drop out as negative), one block of items. Parent: the 256-row block
    with the most slots."""
    import torch

    from splatfields_torch.ops.segsum import block_ranges, items_per_block
    if design == "merge":
        r0, r1, s0, s1 = block_ranges(sidx, n_rows, items_per_block(d))
        b = int(torch.argmax((r1 - r0) + (s1 - s0)))
        a, z, lo, hi = int(s0[b]) & ~3, int(s1[b]), int(r0[b]), int(r1[b])
        items = (hi - lo) + (z - a)
        what = (f"block {b}: rows {hi - lo}, slots {z - int(s0[b])} "
                f"of {r0.shape[0]} blocks")
    else:
        rows = torch.arange(0, n_rows + 256, 256, device=sidx.device)
        bounds = torch.searchsorted(sidx, rows.clamp_max(n_rows).to(
            torch.int32))
        b = int(torch.argmax(bounds[1:] - bounds[:-1]))
        a, z = int(bounds[b]), int(bounds[b + 1])
        lo, hi, items = b * 256, min((b + 1) * 256, n_rows), None
        what = f"block {b}: rows {hi - lo}, slots {z - a}"
    return ((sidx[a:z] - lo).contiguous(), vals[a:z].contiguous(), hi - lo,
            items, what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent design")
    ap.add_argument("--iters", type=int, default=20)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_segsum: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from splatfields_torch.models import splats
    from splatfields_torch.ops.segsum import block_ranges, items_per_block
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    designs = [("change", ROOT / "splatfields_torch" / "csrc")]
    if opts.parent:
        designs.append(("parent", pathlib.Path(opts.parent).resolve()
                        / "splatfields_torch" / "csrc"))
    out_dir = ROOT / "build" / "profile_segsum"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_variants(designs, out_dir)
    design = {label: design_of(csrc) for label, csrc in designs}

    dev = torch.device("cuda")
    sc = cs.serving_scene(dev)
    deform = cs.ngp_model(dev)
    step = cs.train_step_fn(deform, sc.pipe, cs.RES)
    lrs = splats.splat_lr_tree(*cs.SPLAT_LRS)
    cams = cs.make_views(cs.TRAIN_WARMUP + cs.TRAIN_STEPS + 1, cs.RES)
    rng = np.random.RandomState(0)   # phase 8's batch: the last of phase 9's
    batch = [cs.train_batch(c, rng, dev) for c in cams][-1]
    (ids, g), (sidx, vals, n_rows) = cs.capture_table_vjp(
        sc, deform, step, batch, lrs)
    del sc, deform, step
    torch.cuda.synchronize()
    m, d = vals.shape
    bytes_moved = sidx.numel() * 4 + vals.numel() * 4 + n_rows * d * 4
    bound_ms = bytes_moved / cs.HBM_BYTES_PER_S * 1e3
    r0, r1, s0, s1 = block_ranges(sidx, n_rows, items_per_block(d))
    print(f"inputs: {m} slots, {n_rows} rows, D {d}; {bytes_moved} bytes, "
          f"bound {bound_ms:.5f} ms; {r0.shape[0]} merge-path blocks of "
          f"{items_per_block(d)} items, slots a block mean "
          f"{float((s1 - s0).float().mean()):.1f} max {int((s1 - s0).max())}"
          f", rows a block max {int((r1 - r0).max())}")
    want = cs.segsum_reference(sidx, vals, n_rows)[0]

    times = {}

    def record(key, fn, eager=True):
        ms = cs.graph_ms(fn, opts.iters)
        times.setdefault(key, []).append(ms)
        line = f"{key}: {ms:.5f} ms (graph replay)"
        if eager:
            e = cs.cuda_ms(fn, opts.iters)
            times.setdefault(key + " eager", []).append(e)
            line += f", {e:.5f} ms eager"
        print(line)

    gos = {label: launcher(design[label], libs[(label, "full")], sidx, vals,
                           n_rows) for label, _ in designs}
    for label, go in gos.items():
        go()
        torch.cuda.synchronize()
        err = cs.segsum_err(go.out, want)
        print(f"{label} kernel vs plain: worst column over its max {err:.3e}")
        if not err <= cs.TOL_SEGSUM:
            raise AssertionError(f"{label} kernel differs from plain: {err}")

    turns = ["parent", "change", "change", "parent"] if opts.parent else \
        ["change", "change"]
    for label in turns:
        record(f"{label} kernel", gos[label])
        record(f"{label} wrapper call", gos[label].call)
    record("index_add_", lambda: torch.zeros(n_rows, d, device=dev)
           .index_add_(0, sidx, vals))

    for label, _ in designs:
        dsn = design[label]
        for variant in RULES[dsn]:
            go = launcher(dsn, libs[(label, variant)], sidx, vals, n_rows,
                          given_edges=variant == "phase 2 alone")
            if variant in ("phase 2 alone", "no prefetch", "64 registers"):
                go()
                torch.cuda.synchronize()
                err = cs.segsum_err(go.out, want)
                if not err <= cs.TOL_SEGSUM:
                    raise AssertionError(f"{label} {variant}: err {err}")
            record(f"{label} {variant}", go, eager=False)
        if dsn == "rows":
            record(f"{label} edge search (searchsorted call)",
                   gos[label].launch.edges, eager=False)
        hs, hv, hn, items, what = heaviest_block(dsn, sidx, vals, n_rows, d)
        go = launcher(dsn, libs[(label, "full")], hs, hv, hn, items)
        print(f"{label} heaviest {what}")
        record(f"{label} heaviest block alone", go, eager=False)
    for items in (1024, 2048, 4096, 6144):
        go = launcher("merge", libs[("change", "full")], sidx, vals, n_rows,
                      items)
        record(f"change kernel, {items} items a block", go, eager=False)

    # the table VJP's other half: _sort_rows on the step's own ids and rows
    perm = torch.sort(ids, stable=True)[1]
    record("torch.sort (stable) of the ids",
           lambda: torch.sort(ids, stable=True), eager=True)
    record("index_select of the rows", lambda: g.index_select(0, perm),
           eager=True)
    print(f"sort inputs: ids {tuple(ids.shape)} {ids.dtype}, rows "
          f"{tuple(g.shape)} {g.dtype}")
    print(json.dumps({"device": smi, "bound_ms": bound_ms, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
