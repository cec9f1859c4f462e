"""How far the summation order alone moves the fused heads in bf16.

    python3 scripts/fused_order_sensitivity.py [--kind deform] [--n 100000]
        [--device cpu]

The plain version (``ops/fused_mlp.py::fused_heads_plain`` and
``fused_heads_bwd_plain``) at bf16 on ``chip_smoke.fused_case`` inputs
(``--kind``: "deform" or "ragged", the published-width deform and
downstream plans), twice: with every product summed by torch's f32 matmul,
and summed in f64 then rounded to f32. Both round the same operands at the
same places, so they differ by the order of the sums alone, which bf16
rounding of each activation (and each leaky mask's sign) can amplify.
Prints the forward's error over each head's output max and the backward's
errors as ``chip_smoke.TOL_FUSED`` reads them ("worst" over each tensor's
max, "mean" over its mean).

For d_emb and d_feat, the points whose error passes 1e-2 of the tensor's
max are counted with their sign margins: the least |pre-activation| over
the point's layers, each over its layer's mean |pre-activation|.

On a CUDA device (``--device cuda``) the kernels run too: against both
orders, with the same counts, and layer by layer on their own rounded
operands (``chip_smoke.check_layers``: how many rounded values land on
the other side of a rounding boundary than the exact sum, and the largest
error that explains one, against TOL_LAYER). The card's name and power
limit head the output there. The same layer-by-layer count is printed for
the f32-summed plain version on either device.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def margins(plan, emb, feat, w, b):
    """Per point, the least |pre-activation| over its layers, each over
    the layer's mean |pre-activation| at that point (bf16 plain forward)."""
    import torch
    bf16 = torch.bfloat16
    out = torch.full((emb.shape[0],), float("inf"), device=emb.device)
    for head in plan.heads:
        h_in = torch.cat([emb[:, :head.emb_cols], feat], 1)
        h = h_in
        for L in head.layers:
            y = (h.to(bf16).float()
                 @ w[L.row_off:L.row_off + L.fin, :L.fout].to(bf16).float()
                 + b[L.bias_idx, :L.fout])
            out = torch.minimum(out, y.abs().min(1).values
                                / y.abs().mean(1).clamp_min(1e-30))
            h = torch.where(y >= 0, y, 0.01 * y)
            if L.skip_after:
                h = torch.cat([h_in, h], 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=("deform", "ragged"), default="deform")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args()
    import torch

    from chip_smoke import (
        check_layers,
        fused_case,
        fused_errs,
        layer_witness,
    )
    from splatfields_torch.ops import fused_mlp as fm
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("fused_order_sensitivity: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())
    bf16 = torch.bfloat16
    case = fused_case(args.kind, dev, n=args.n)
    plan, emb, feat, w, b, _ = case

    matmul = torch.Tensor.__matmul__

    def plain(f64):
        if f64:
            torch.Tensor.__matmul__ = (
                lambda x, y: matmul(x.double(), y.double()).float())
        try:
            with torch.no_grad():
                fwd = fm.fused_heads_plain(plan, emb, feat, w, b, bf16)
            return fwd, fm.fused_heads_bwd_plain(*case, bf16)
        finally:
            torch.Tensor.__matmul__ = matmul

    def fwd_err(got, want):
        return max(float((g - x).abs().max() / x.abs().max())
                   for g, x in zip(got, want))

    f32, f64 = plain(False), plain(True)
    marg = margins(plan, emb, feat, w, b)
    quant = torch.quantile(marg[:50_000].float(), torch.tensor(
        [0.001, 0.01, 0.5], device=dev)).tolist()
    print(f"sign margin quantiles (0.1%, 1%, 50%) of the first 50,000 "
          f"points: {[f'{q:.3e}' for q in quant]}")

    def witness(name, st):
        print(f"{name} layer by layer: {st['values']} rounded values, "
              f"{st['flips']} on the other side of a rounding boundary than "
              f"the exact sum ({st['flips'] / st['values']:.3e} of them), "
              f"the largest gap explaining one {st['gap']:.3e} of its "
              "terms' magnitudes")

    def report(name, fwd, bwd, ref, ref_name):
        print(f"{name} vs {ref_name} plain: forward "
              f"{fwd_err(fwd, ref[0]):.3e}, backward "
              f"{fused_errs(plan, bwd, ref[1])}")
        for part, got, want in (("d_emb", bwd[0], ref[1][0]),
                                ("d_feat", bwd[1], ref[1][1])):
            err = (got - want).abs().max(1).values / want.abs().max()
            bad = marg[err > 1e-2].float()
            q = ([f"{float(x):.3e}" for x in torch.quantile(
                bad, torch.tensor([0.0, 0.5, 1.0], device=dev))]
                 if bad.numel() else [])
            print(f"  {part}: {bad.numel()} points above 1e-2 of the max; "
                  f"their sign margins (min, median, max) {q}")

    report("f64-summed plain", f64[0], f64[1], f32, "f32-summed")
    witness("f32-summed plain", layer_witness(
        *case, f32[0], f32[1][0], f32[1][1],
        fm.dw_scratch_plain(*case, bf16), f32[1][3]))
    if dev.type != "cuda":
        return 0
    with torch.no_grad():
        kfwd = fm.fused_heads(plan, emb, feat, w, b, bf16)
    kbwd = fm.fused_heads_bwd(*case, bf16)
    for name, ref in (("f32-summed", f32), ("f64-summed", f64)):
        report("kernels", kfwd, kbwd, ref, name)
    witness("kernels", check_layers(f"{args.kind}, N {args.n}", *case))
    return 0


if __name__ == "__main__":
    sys.exit(main())
