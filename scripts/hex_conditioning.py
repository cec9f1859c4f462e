"""Why ``chip_smoke.py`` phase 31's small VarHexPlane step (``SMALL_HEX``:
per-frame conv deltas, 2,000 splats, 64x64, 2 views) passes its
card-against-CPU check at some net weights and misses it at others.

For each seed of ``chip_smoke.HEX_SEEDS`` and two draw orders of the
ResField ``vm`` layers (the current one, ``weights_t`` before
``matrix_t``, and an earlier draft's, ``matrix_t`` first: the weights at
which the check once missed), it prints the largest difference of the
step's screen-offset gradient over its max:

- ``step``: the full training step, card against CPU (phase 31's check);
- ``render``: the field's attributes, render and loss on the card
  against the CPU, each from its own attributes;
- ``card_attrs``: the CPU's render and loss on the card's attributes
  against the CPU's own (what is left once both sides render the same
  attributes);
- ``plain``: the card with the plain blends in place of the kernels
  against the card with the kernels;
- ``f64``: the CPU's render on the float64 attributes against the CPU's;
- ``noise``: the CPU's render on its attributes times (1 +- 1e-6)
  uniform noise, the worst of 5 draws, against the CPU's;

and the attributes' largest relative error against float64, card and
CPU. A jump that the CPU's own render shows under 1e-6 relative noise is
the step's conditioning, not a fault of the card's path.

    python3 scripts/hex_conditioning.py

Needs a CUDA card; prints one JSON line with the card's name and power.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NOISE, DRAWS = 1e-6, 5


def draft_order_init(orig):
    """``ResFieldLinear.__init__`` drawing each active lookup ``vm``
    layer's ``matrix_t`` before its ``weights_t`` from the same stream
    (the generator ends where the current order leaves it)."""
    import torch

    from splatfields_torch.models.initializers import torch_linear_

    def init(self, in_features, out_features, rank=0, capacity=0,
             mode="lookup", compression="vm", fuse_mode="add", *, generator,
             **kw):
        start = generator.get_state()
        orig(self, in_features, out_features, rank, capacity, mode,
             compression, fuse_mode, generator=generator, **kw)
        if not (self.active and compression == "vm" and mode == "lookup"
                and fuse_mode == "add" and kw.get("chunk_size") is None):
            return
        end = generator.get_state()
        generator.set_state(start)
        torch_linear_(torch.empty(out_features, in_features),
                      torch.empty(out_features), in_features, generator)
        m = 0.01 * torch.randn(rank, in_features * out_features,
                               generator=generator)
        w = 0.01 * torch.randn(self.weights_t.shape[0], rank,
                               generator=generator)
        if not torch.equal(generator.get_state(), end):
            raise AssertionError("the draft order drew another count")
        with torch.no_grad():
            self.matrix_t.copy_(m)
            self.weights_t.copy_(w)

    return init


class PlainBlends:
    """The plain blends in place of the kernels for CUDA tensors."""

    def __enter__(self):
        import torch

        from splatfields_torch.ops.raster import blend_cuda, blend_torch

        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, pack, start, counts, ids, tx, ty, ts, tc, kc):
                out = blend_torch.blend_sorted_plain(pack, start, counts, tx,
                                                     ty, ts, tc, kc, ids)
                ctx.save_for_backward(pack, start, counts, ids, *out)
                ctx.args = (tx, ts, tc, kc)
                return out

            @staticmethod
            def backward(ctx, *gs):
                pack, start, counts, ids, *out = ctx.saved_tensors
                gs = [torch.zeros_like(o) if g is None else g.contiguous()
                      for g, o in zip(gs, out)]
                grad = blend_torch.blend_bwd_plain(pack, start, counts, ids,
                                                   *gs, *out, *ctx.args)
                return (grad,) + (None,) * 8

        self.module, self.kernel = blend_cuda, blend_cuda._Blend
        blend_cuda._Blend = Plain
        return self

    def __exit__(self, *exc):
        self.module._Blend = self.kernel


def study(dev, pts, cols, seed):
    import torch

    import chip_smoke as cs
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    a_cpu = cs.hex_attributes(cpu, pts, cols, seed)
    a_card = {k: v.cpu() for k, v in
              cs.hex_attributes(dev, pts, cols, seed).items()}
    a_f64 = cs.hex_attributes(cpu, pts, cols, seed, torch.float64)
    ref = cs.hex_screen_grad(a_cpu, cpu)
    card = cs.hex_screen_grad(a_card, dev)

    def gap(g, want=ref):
        return float((g - want).abs().max() / want.abs().max())

    with PlainBlends():
        plain = cs.hex_screen_grad(a_card, dev)
    noisy = []
    for _ in range(DRAWS):
        pert = {k: v * (1 + NOISE * (2 * torch.rand(v.shape, generator=gen)
                                     - 1)) if v.is_floating_point() else v
                for k, v in a_cpu.items()}
        noisy.append(gap(cs.hex_screen_grad(pert, cpu)))
    step = {k: cs.hex_step(d, pts, cols, seed)[5].screen_grad.cpu().double()
            for k, d in (("card", dev), ("cpu", cpu))}
    rel = {}
    for name, a in (("card", a_card), ("cpu", a_cpu)):
        rel[name] = {k: float((a[k].double() - a_f64[k].double()).abs().max()
                              / a_f64[k].double().abs().max())
                     for k in ("means3d", "scales", "rotations", "opacity",
                               "rgb")}
    return {"step": gap(step["card"], step["cpu"]), "render": gap(card),
            "card_attrs": gap(cs.hex_screen_grad(a_card, cpu)),
            "plain": gap(plain, card), "f64": gap(cs.hex_screen_grad(
                a_f64, cpu)), "noise": noisy, "attr_err_vs_f64": rel}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hex_conditioning: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from splatfields_torch.device import full_f32_math
    from splatfields_torch.models import resfields
    from splatfields_torch.ops.raster import blend_cuda
    full_f32_math()
    os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    blend_cuda.build()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (cs.N_SPLATS, 3)).astype(np.float32)
    cols = rng.rand(cs.N_SPLATS, 3).astype(np.float32)
    current = resfields.ResFieldLinear.__init__
    out = {}
    for order, init in (("current", current),
                        ("draft", draft_order_init(current))):
        resfields.ResFieldLinear.__init__ = init
        try:
            out[order] = {s: study(dev, pts, cols, s) for s in cs.HEX_SEEDS}
        finally:
            resfields.ResFieldLinear.__init__ = current
        for s, r in out[order].items():
            print(order, s, {k: v for k, v in r.items()
                             if k != "attr_err_vs_f64"}, flush=True)
    print(json.dumps({"card": smi, "noise": NOISE, "draws": DRAWS,
                      "orders": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
