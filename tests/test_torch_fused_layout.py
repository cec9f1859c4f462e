"""The fused heads' kernel layouts (``splatfields_torch/ops/fused_mlp.py``)
and the kernel cache's names (``splatfields_torch/ops/cuda_build.py``), on
the CPU, without JAX:

- a library's name follows every header of ``csrc/``, so an edited
  ``fused_mlp_mma.cuh`` is rebuilt, and an unchanged tree is not;
- for the published VarTriPlane, NGP, TriPlane (F = 48 from learned
  planes), Grid (F = 24) and view-dependent (an ``mlp_rgb`` of 128
  outputs) plans and chip_smoke.py's three fused cases: the bf16 kernels' chunks are whole mma row tiles, fit in
  shared memory and divide the dW slices' row alignment; every layer's
  padded K is round16(fin); the weight ring holds any two consecutive
  tiles of its schedule; the wrapper's bf16 weights are ``w`` rounded,
  zero in every padding row.
"""
import functools
import shutil

import pytest
import torch

from chip_smoke import fused_case
from splatfields_torch.config import HiddenConfig
from splatfields_torch.models.deform_model import build_splatfields
from splatfields_torch.ops import cuda_build
from splatfields_torch.ops import fused_mlp as fm

BF16 = torch.bfloat16


# published head widths; the encoders' sizes do not reach the plans
SMALL_ENCODERS = {"NGPMLP": dict(log2_hashmap_size=12),
                  "TriPlaneEncoder": dict(encoder_args={"resolution": 8}),
                  "GridEncoder": dict(encoder_args={"resolution": 8})}


@functools.cache
def _published(encoder, mode, view_dep=False):
    net = build_splatfields(
        HiddenConfig(encoder_type=encoder, composition_rank=0, n_frames=0,
                     use_view_dep_rgb=view_dep,
                     **SMALL_ENCODERS.get(encoder, {})), 1.0,
        generator=torch.Generator().manual_seed(0))
    plan = fm.plan_from_module(net, mode)
    return plan, fm.pack_params(net, plan)[0].detach()


@functools.cache
def _case(kind):
    plan, _, _, w, _, _ = fused_case(kind, torch.device("cpu"), n=8)
    return plan, w


PLANS = {
    "vartriplane-deform": lambda: _published("VarTriPlaneEncoder", "deform"),
    "vartriplane-downstream": lambda: _published("VarTriPlaneEncoder",
                                                 "downstream"),
    "ngp-deform": lambda: _published("NGPMLP", "deform"),
    "ngp-downstream": lambda: _published("NGPMLP", "downstream"),
    "triplane-deform": lambda: _published("TriPlaneEncoder", "deform"),
    "triplane-downstream": lambda: _published("TriPlaneEncoder",
                                              "downstream"),
    "grid-deform": lambda: _published("GridEncoder", "deform"),
    "grid-downstream": lambda: _published("GridEncoder", "downstream"),
    "view-dep-downstream": lambda: _published("VarTriPlaneEncoder",
                                              "downstream", True),
    "ragged": lambda: _case("ragged"),
    "no_features": lambda: _case("no_features"),
    "skip_last_but_one": lambda: _case("skip_last_but_one"),
}


def _up(x, m):
    return x + (-x) % m


def test_library_name_follows_the_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    sources = sorted(csrc.glob("*.cu"))
    header = csrc / "fused_mlp_mma.cuh"
    assert sources and header.exists()
    before = [cuda_build._lib_path(s) for s in sources]
    assert [cuda_build._lib_path(s) for s in sources] == before
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    after = [cuda_build._lib_path(s) for s in sources]
    assert all(a != b for a, b in zip(after, before))
    assert all(a.name.startswith(f"lib{s.stem}-")
               for a, s in zip(after, sources))
    header.write_text(text)
    assert [cuda_build._lib_path(s) for s in sources] == before


@pytest.mark.parametrize("name", list(PLANS))
def test_bf16_chunks_are_mma_tiles_and_fit(name):
    plan, _ = PLANS[name]()
    fwd, bwd = fm.fwd_layout(plan, BF16), fm.bwd_layout(plan, BF16)
    for lay in (fwd, bwd):
        assert lay.points % 16 == 0 and lay.points > 0
        assert lay.smem <= fm.SMEM_LIMIT
        assert lay.w_region % 8 == 0
    # every chunk of the backward lies within one dW slice of N
    for dtype in (torch.float32, BF16):
        assert fm.ROW_ALIGN % fm.bwd_layout(plan, dtype).points == 0
    # the published widths keep 64 points a chunk (one CTA an SM); the
    # view-dependent head's backward takes 32 (its 128-wide last layer)
    if not name.startswith(("ragged", "no_", "skip")):
        want = 32 if name == "view-dep-downstream" else 64
        assert (fwd.points, bwd.points) == (64, want)
    hin = max(h.emb_cols + plan.feat_dim for h in plan.heads)
    fin = max(L.fin for h in plan.heads for L in h.layers)
    for lay in (fwd, bwd):
        assert lay.hin_stride >= _up(hin, 16) and lay.width_stride >= _up(
            fin, 16)
    # the bytes the kernels' launchers recompute and compare
    xs = plan.emb_dim + plan.feat_dim
    assert fwd.smem == 2 * (fwd.w_region + fwd.points * (
        fwd.hin_stride + 2 * fwd.width_stride)) + 4 * fwd.points * xs
    words = max(sum(-(-L.fout // 32) for L in h.layers[:-1])
                for h in plan.heads)
    last = max(h.layers[-1].fout for h in plan.heads)
    union = bwd.points * max(bwd.hin_stride + 2 * bwd.width_stride,
                             2 * bwd.width_stride + fm.LD_G)
    assert bwd.smem == 2 * (bwd.w_region + union) + 4 * (
        fm.THREADS_MMA + bwd.points * (words + last + 2 * xs))


@pytest.mark.parametrize("name", list(PLANS))
def test_padded_k_is_round16_of_fin(name):
    plan, _ = PLANS[name]()
    for h in plan.heads:
        for L in h.layers:
            k, n, ld = fm.mma_tile(L)
            assert k == _up(L.fin, 16) and n == _up(L.fout, 16)
            # a row is an odd multiple of 16 bytes: ldmatrix conflict-free
            assert ld >= n and (2 * ld) % 32 == 16


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("name", list(PLANS))
def test_weight_ring_holds_consecutive_tiles(name, backward):
    plan, _ = PLANS[name]()
    layers = [L for h in plan.heads for L in h.layers]
    sched = fm.weight_schedule(plan, backward)
    assert len(sched) == len(layers) * (2 if backward else 1)
    if backward:   # per head: its layers, then the same in reverse
        pos = 0
        for h in plan.heads:
            ids = sched[pos:pos + 2 * len(h.layers)]
            assert ids[:len(h.layers)] == ids[len(h.layers):][::-1]
            pos += 2 * len(h.layers)
    else:
        assert sched == list(range(len(layers)))
    lay = (fm.bwd_layout if backward else fm.fwd_layout)(plan, BF16)
    size = [_up(layers[i].fin, 16) * (_up(layers[i].fout, 16) + 8)
            for i in sched]
    for s in range(len(sched)):
        assert size[s] + size[(s + 1) % len(sched)] <= lay.w_region
    assert lay.w_region == max(size[s] + size[(s + 1) % len(sched)]
                               for s in range(len(sched)))


@pytest.mark.parametrize("name", list(PLANS))
def test_bf16_weight_copy(name):
    plan, w = PLANS[name]()
    got = fm.kernel_weights(w, BF16)
    assert got.dtype == BF16 and got.shape == w.shape
    assert torch.equal(got, w.to(torch.bfloat16))
    assert fm.kernel_weights(w, torch.float32) is w
    for h in plan.heads:
        for L in h.layers:
            block = got[L.row_off:L.row_off + _up(L.fin, 8)]
            assert not block[L.fin:].any(), (h.name, L)
            assert not block[:, L.fout:].any(), (h.name, L)
            assert block[:L.fin, :L.fout].any()


@pytest.mark.parametrize("name,feat,rgb_out", [
    ("triplane-downstream", 48, 3), ("grid-downstream", 24, 3),
    ("view-dep-downstream", 48, 128)])
def test_field_option_plans(name, feat, rgb_out):
    """The field options' plans: the feature width reaches every head's
    first layer, whose packed block rounds it to 8 rows and its mma tile
    to 16 (F = 24: 24 + 39 = 63 -> 64 rows either way; the view-dependent
    head's last layer fills all 128 columns)."""
    plan, _ = PLANS[name]()
    assert plan.feat_dim == feat and plan.heads[0].out_dim == rgb_out
    assert plan.heads[0].layers[-1].fout == rgb_out
    for h in plan.heads:
        first, second = h.layers[:2]
        assert first.fin == h.emb_cols + feat
        assert second.row_off - first.row_off == _up(first.fin, 8)
        assert fm.mma_tile(first)[0] == _up(first.fin, 16)
