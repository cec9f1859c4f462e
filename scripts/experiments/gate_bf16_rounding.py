"""An experiment, not an option and not part of the port: the port's
quality gate with the TPU's default matmul arithmetic. It is kept only as
the source of the readings PERF.md cites.

On a TPU the JAX package runs every flax ``Dense``, the MLP products and
the plane CNN's ``conv_general_dilated`` at XLA's DEFAULT precision: one
bf16 pass on the MXU, its inputs rounded to bf16 and the products summed
in f32, in the forward and in the backward. Only the sites marked
``precision="highest"`` run in f32 (preprocess, the ResField
``matrix_t`` composition, the attention scores, the flow's transforms,
the splats). The port runs them all in f32 with TF32 off. This script
trains ``scripts/quality_gate_torch.py``'s gate twice in one process at
each seed, once as the port ships it and once with the inputs of every
``F.linear`` (every ``nn.Linear``, ``ResFieldLinear`` and head layer) and
of every plane-decoder convolution (``decoder.TimeConv``) rounded to bf16,
round to nearest even, in both passes (the upstream gradient too), the
sums and the bias add in f32. The SSIM's convolutions stay f32, as JAX's
shift-and-add SSIM is.

    python3 scripts/experiments/gate_bf16_rounding.py --variant field \\
        --seeds 0,1,2,3,4
    python3 scripts/experiments/gate_bf16_rounding.py --variant owlii4d \\
        --iters 3000 --seeds 42

Card only; it prints a line a run and one JSON line with each seed's pair
(f32, rounded), the mean of rounded - f32, its sample standard deviation
and standard error, and the card's name and power limit. It writes no file.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import quality_gate_torch as qg  # noqa: E402


def bf16(t):
    import torch
    return t.to(torch.bfloat16).to(t.dtype)


def _linear_fn():
    """A rounded ``F.linear`` over the ``F.linear`` of the moment."""
    import torch
    import torch.nn.functional as F
    f32_linear = F.linear

    class RoundedLinear(torch.autograd.Function):
        """y = bf16(x) bf16(w)^T + b; dx = bf16(dy) bf16(w), dw = bf16(dy)^T
        bf16(x), as a DEFAULT-precision dot and its transposes."""

        @staticmethod
        def forward(ctx, x, w, b):
            xr, wr = bf16(x), bf16(w)
            ctx.save_for_backward(xr, wr)
            ctx.has_bias = b is not None
            return f32_linear(xr, wr, b)

        @staticmethod
        def backward(ctx, dy):
            xr, wr = ctx.saved_tensors
            g = bf16(dy)
            dx = g @ wr
            dw = g.reshape(-1, g.shape[-1]).t() @ xr.reshape(-1, xr.shape[-1])
            db = (dy.reshape(-1, dy.shape[-1]).sum(0) if ctx.has_bias
                  else None)
            return dx, dw, db

    def linear(x, w, b=None):
        return RoundedLinear.apply(x, w, b)

    return linear


def _conv_fn():
    import torch
    import torch.nn.functional as F
    from torch.nn import grad as nn_grad

    class RoundedConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b, stride, padding, dilation, groups):
            xr, wr = bf16(x), bf16(w)
            ctx.save_for_backward(xr, wr)
            ctx.conf = (stride, padding, dilation, groups)
            ctx.has_bias = b is not None
            return F.conv2d(xr, wr, b, stride, padding, dilation, groups)

        @staticmethod
        def backward(ctx, dy):
            xr, wr = ctx.saved_tensors
            stride, padding, dilation, groups = ctx.conf
            g = bf16(dy)
            dx = nn_grad.conv2d_input(xr.shape, wr, g, stride, padding,
                                      dilation, groups)
            dw = nn_grad.conv2d_weight(xr, wr.shape, g, stride, padding,
                                       dilation, groups)
            db = dy.sum((0, 2, 3)) if ctx.has_bias else None
            return dx, dw, db, None, None, None, None

    def conv_forward(self, x, w, b):
        return RoundedConv.apply(x, w, b, self.stride, self.padding,
                                 self.dilation, self.groups)

    return conv_forward


@contextlib.contextmanager
def tpu_default_precision():
    """Inside: ``F.linear`` and ``TimeConv``'s convolutions round their
    inputs to bf16 in both passes."""
    import torch.nn.functional as F

    from splatfields_torch.models import decoder
    saved = F.linear, decoder.TimeConv._conv_forward
    F.linear, decoder.TimeConv._conv_forward = _linear_fn(), _conv_fn()
    try:
        yield
    finally:
        F.linear, decoder.TimeConv._conv_forward = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=tuple(qg.OPTIONS), default="field")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seeds", default="0,1,2,3,4")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("gate_bf16_rounding: no CUDA device", file=sys.stderr)
        return 1
    from splatfields_torch.device import full_f32_math
    full_f32_math()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    pairs = {}
    for seed in seeds:
        row = []
        for rounded in (False, True):
            ctx = tpu_default_precision() if rounded else \
                contextlib.nullcontext()
            with ctx:
                psnrs, loss, train_s, _ = qg.train_and_eval(
                    args.variant, seed, args.iters, dev)
            row.append(float(np.mean(psnrs)))
            print(json.dumps({"seed": seed, "rounded": rounded,
                              "psnr_db": row[-1], "per_view": psnrs,
                              "final_loss": loss, "train_s": train_s}),
                  flush=True)
        pairs[seed] = row
    gaps = [pairs[s][1] - pairs[s][0] for s in seeds]
    mean, sd, se = qg.spread(gaps)
    print(json.dumps({
        "variant": args.variant, "iters": args.iters, "seeds": seeds,
        "net_seed": qg.NET_SEED, "pairs_f32_rounded": pairs,
        "rounded_minus_f32_db": gaps, "mean_db": mean, "sd_db": sd,
        "stderr_db": se,
        "options": {o: os.environ.get(o, "auto")
                    for o in qg.OPTIONS[args.variant]},
        "card": smi, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
