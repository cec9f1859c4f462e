"""The fused MLP-head CUDA kernels against their plain PyTorch version, on
the GPU, and a SplatFields forward and backward through them.

Needs a CUDA card (and nvcc to build the kernels); skips elsewhere.
Imports no JAX, so on the GPU machine it runs without this directory's
conftest:

    python -m pytest --noconftest tests/test_torch_fused_mlp_cuda.py -q

Tolerances: chip_smoke.TOL_FUSED, per compute type (its comment gives the
reasons); ``fused_mlp_dw`` against ``fused_dw_plain`` on one scratch
chip_smoke.TOL_DW of each entry's sum of term magnitudes; the reduction
chip_smoke.TOL_SEGSUM of the max. Two launches of
the backward, of ``fused_mlp_dw`` and of the reduction on the same inputs
are bitwise equal.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    TOL_SEGSUM,
    check_dw,
    check_fused,
    check_layers,
    fused_case,
)
from splatfields_torch.models.splatfields import SplatFields
from splatfields_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    # the checks here are f32: the JAX package's bf16 defaults, on for
    # CUDA tensors under "auto", stay off
    monkeypatch.setenv("SPLATFIELDS_MLP_BF16", "off")
    monkeypatch.setenv("SPLATFIELDS_NGP_BF16_TABLE", "off")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["ragged", "no_features",
                                  "skip_last_but_one"])
def test_kernels_match_plain(cuda, kind, dtype):
    case = fused_case(kind, cuda)
    before = (fm.fused_heads.launches, fm.fused_heads_bwd.launches,
              fm.fused_dw.launches, fm.reduce_partials.launches)
    check_fused(kind, *case, DTYPES[dtype])
    # one forward, two backward launches (each with its dW and reduction)
    assert (fm.fused_heads.launches - before[0],
            fm.fused_heads_bwd.launches - before[1],
            fm.fused_dw.launches - before[2],
            fm.reduce_partials.launches - before[3]) == (1, 2, 2, 2)


@pytest.mark.parametrize("kind", ["deform", "ragged"])
def test_published_plans_bf16(cuda, kind):
    """Both published plans (deform, and downstream as "ragged"; F = 48)
    at bf16, every product on the tensor cores, N = 1,037: the forward and
    the backward within TOL_FUSED of the plain version, two backward
    launches bitwise equal. (At N = 100,000 on these random inputs another
    summation order alone, the exact one included, moves the worst
    gradient past TOL_FUSED's bound; test_layers_on_own_operands holds the
    kernels there.)"""
    check_fused(f"published {kind}", *fused_case(kind, cuda),
                torch.bfloat16)


@pytest.mark.parametrize("n", [1037, 100_000])
@pytest.mark.parametrize("kind", ["deform", "ragged", "no_features",
                                  "skip_last_but_one"])
def test_layers_on_own_operands(cuda, kind, n):
    """Both bf16 kernels layer by layer (chip_smoke.layer_witness): every
    rounded value they keep, every output and d_emb / d_feat within
    TOL_LAYER of the exact sum of the same layer's products of their own
    bf16 operands; copies and padding exact."""
    st = check_layers(f"{kind}, N {n}", *fused_case(kind, cuda, n=n))
    assert st["values"] > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,n", [("ragged", 1037), ("no_features", 1037),
                                    ("skip_last_but_one", 1037),
                                    ("ragged", 100_000)])
def test_dw_matches_plain(cuda, kind, n, dtype):
    """fused_mlp_dw (bf16: tensor cores; f32: CUDA cores) against
    fused_dw_plain on the backward kernel's own scratch, which must equal
    dw_scratch_plain's bit for bit where the recompute agrees."""
    case = fused_case(kind, cuda, n=n)
    _, _, scratch, _ = fm.launch_bwd(*case, DTYPES[dtype])
    check_dw(f"{kind}, N {n}", case[0], scratch, n)
    if n < 10_000:
        want = fm.dw_scratch_plain(*case, DTYPES[dtype])
        torch.cuda.synchronize()
        # padding and layout: zero wherever the plain version is zero, and
        # close on average elsewhere (a value whose leaky mask flips
        # between the two recomputes moves by 99%: rare)
        assert bool((scratch[want == 0] == 0).all())
        err = (scratch.float() - want.float()).abs().mean()
        assert float(err) <= 1e-3 * float(want.float().abs().mean())


def test_bf16_rounds_the_operands(cuda):
    """The bf16 kernel differs from the f32 plain version by the rounding
    of its operands, far more than from the bf16 plain version on the same
    rounded operands: each head's last layer on the input the kernels
    computed for it (the backward's recompute, every layer of which
    layer_witness holds to its own operands). End to end, another
    summation order alone moves the bf16 plain version by more than 1e-5
    of the max (scripts/fused_order_sensitivity.py), so the tensor cores'
    order is compared layer by layer."""
    case = fused_case("ragged", cuda)
    plan, emb, feat, w, b, _ = case
    n = emb.shape[0]
    with torch.no_grad():
        got = fm.fused_heads(plan, emb, feat, w, b, torch.bfloat16)
        f32 = fm.fused_heads_plain(plan, emb, feat, w, b, torch.float32)
    check_layers("ragged", *case)
    blocks = fm.scratch_blocks(plan, fm.launch_bwd(*case, torch.bfloat16)[2],
                               n)
    last = -1
    for head, g, a in zip(plan.heads, got, f32):
        last += len(head.layers)
        L = head.layers[-1]
        x = blocks[last][0][:n, :L.fin].float()
        wl = w[L.row_off:L.row_off + L.fin, :L.fout].to(torch.bfloat16)
        r = torch.nn.functional.leaky_relu(
            x @ wl.float() + b[L.bias_idx, :L.fout], fm.ALPHA)
        scale = float(r.abs().max())
        assert float((g - a).abs().max()) > 1e-4 * scale
        assert float((g - r).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 5, 64])
def test_small_and_ragged_n(cuda, n, dtype):
    plan, emb, feat, w, b, gs = fused_case("skip_last_but_one", cuda, n=n)
    check_fused(f"N {n}", plan, emb, feat, w, b, gs, DTYPES[dtype])


@pytest.mark.parametrize("shapes", [((10, 300_032), (132, 3200)),
                                    ((30, 137_216), (1, 1024)),
                                    ((132, 5000), (3, 0))])
def test_reduce_matches_sum(cuda, shapes):
    rng = np.random.RandomState(0)
    parts = [torch.as_tensor(rng.randn(*s).astype(np.float32), device=cuda)
             for s in shapes]
    got = fm.reduce_partials(*parts)
    again = fm.reduce_partials(*parts)
    for g, a, p in zip(got, again, parts):
        want = p.sum(0)
        assert torch.equal(g, a)
        if want.numel():
            assert float((g - want).abs().max() / want.abs().max()) <= (
                TOL_SEGSUM)
    with pytest.raises(ValueError):
        fm.reduce_partials(parts[0][:, :-1].contiguous(), parts[1])


def test_wrapper_refuses_bad_inputs(cuda):
    plan, emb, feat, w, b, gs = fused_case("ragged", cuda, n=40)
    with pytest.raises(ValueError):
        fm.fused_heads_bwd(plan, emb, feat, w[:-8], b, gs)
    with pytest.raises(TypeError):
        fm.fused_heads_bwd(plan, emb.double(), feat, w, b, gs)
    with pytest.raises(ValueError):
        fm.fused_heads_bwd(plan, emb, feat.cpu(), w, b, gs)
    with pytest.raises(TypeError):
        fm.fused_heads(plan, emb, feat, w, b, torch.float16)
    scratch = fm.launch_bwd(plan, emb, feat, w, b, gs, torch.bfloat16)[2]
    with pytest.raises(ValueError):
        fm.fused_dw(plan, scratch[:-8], 40)
    with pytest.raises(TypeError):
        fm.fused_dw(plan, scratch.half(), 40)


def test_splatfields_fused_on_card_matches_cpu(cuda):
    """A small SplatFields with fused_pallas="on" at f32: outputs and
    every parameter's gradient on the card (kernels, two forward and two
    backward launches) against the CPU (plain version)."""
    kw = dict(encoder_type="VarTriPlaneEncoder",
              encoder_args={"noise_res": 4}, deform_w=32, deform_d=3,
              rgb_w=32, rgb_d=3, scale_w=16, scale_d=2, opacity_w=16,
              opacity_d=2, rotation_w=16, rotation_d=2, deform_skips=(1,),
              rgb_skips=(1,), scale_skips=(1,), opacity_skips=(1,),
              fused_pallas="on", fused_compute_dtype=torch.float32)
    x = np.random.RandomState(0).uniform(-0.8, 0.8, (300, 3)).astype(
        np.float32)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        net = SplatFields(**kw, generator=torch.Generator().manual_seed(0))
        net = net.to(dev)
        before = (fm.fused_heads.launches, fm.fused_heads_bwd.launches)
        out = net(torch.as_tensor(x, device=dev))
        loss = sum(out[k].sum() * s for k, s in (
            ("means3D", 1.0), ("rgb", 1.0), ("scales", 0.1),
            ("opacity", 1.0), ("rotations", 0.2)))
        names, params = zip(*net.named_parameters())
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        assert (fm.fused_heads.launches - before[0],
                fm.fused_heads_bwd.launches - before[1]) == (
                    (2, 2) if dev.type == "cuda" else (0, 0))
        res[dev.type] = ({k: v.detach().cpu() for k, v in out.items()
                          if v is not None},
                         {k: g.cpu() for k, g in zip(names, grads)})
    (out_g, g_g), (out_c, g_c) = res["cuda"], res["cpu"]
    for k, want in out_c.items():
        torch.testing.assert_close(out_g[k], want, rtol=1e-5, atol=1e-5)
    for k, want in g_c.items():
        if k.startswith("mlp_"):
            scale = float(want.abs().max())
            assert scale > 0, k
            assert float((g_g[k] - want).abs().mean()) <= 1e-4 * float(
                want.abs().mean()) + 1e-12, k
            assert float((g_g[k] - want).abs().max()) <= 5e-2 * scale, k
