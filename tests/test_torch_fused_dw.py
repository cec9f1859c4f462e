"""The fused heads' weight gradient as the port computes it on the card,
held on the CPU: the scratch buffer the backward kernel writes
(``dw_scratch_layout``, ``dw_scratch_plain``) and the split-K product over
N that ``fused_mlp_dw`` computes from it (``dw_tiles``, ``dw_slices``,
``fused_dw_plain``), against the port's plain backward
(``fused_heads_bwd_plain``) and the JAX package's ``fused_heads`` custom
VJP (``splatfields_tpu/ops/fused_mlp.py``, its Pallas kernels in interpret
mode).

The plan has the published layer structure at narrow widths: skips
(``[h_in, x]`` inputs), a head without one, last layers of 1, 3 and 4
outputs; N = 37 is ragged (past every chunk and slice edge), N = 293 gives
the slice counts room; F = 6 and F = 0.

Tolerances, max abs error over the reference's max abs. Against the plain
backward: both sides hold the same rounded X_l and G_l (the same autograd
graph) and differ only in the order of the final f32 sums, so 1e-6 at f32
and bf16. Against JAX: the same products summed in another order, 1e-6 at
f32; in bf16 a sum that lands on the other side of a bf16 rounding
boundary moves one value by 2^-8, so tests/test_torch_fused_mlp.py's
bound of 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_torch.ops import fused_mlp as fm
from splatfields_tpu.ops import fused_mlp as jfm

CFGS = [dict(name="a", emb_cols=15, hidden=16, depth=3, skips=(1,), out=3),
        dict(name="b", emb_cols=9, hidden=8, depth=2, skips=(20,), out=4),
        dict(name="c", emb_cols=9, hidden=24, depth=2, skips=(0,), out=1)]
E = 15
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# chip_smoke.DOWNSTREAM_CFGS and the deform head: the published widths
PUBLISHED = {
    "deform": [dict(name="mlp_deform", emb_cols=39, hidden=128, depth=6,
                    skips=(3,), out=3)],
    "downstream": [
        dict(name="mlp_rgb", emb_cols=39, hidden=128, depth=6, skips=(3,),
             out=3),
        dict(name="mlp_scale", emb_cols=27, hidden=64, depth=4, skips=(2,),
             out=3),
        dict(name="mlp_opacity", emb_cols=21, hidden=64, depth=4,
             skips=(2,), out=1),
        dict(name="mlp_rotation", emb_cols=21, hidden=64, depth=3,
             skips=(20,), out=4)]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(feat_dim, n, seed=0):
    """The plan and numpy inputs: packed weights and biases zero in the
    padding, standard normal embeddings, features and cotangents."""
    plan = fm.build_plan(CFGS, E, feat_dim)
    rng = np.random.RandomState(seed)
    w = np.zeros((plan.n_rows, fm.COLS), np.float32)
    b = np.zeros((plan.n_bias, fm.COLS), np.float32)
    for head in plan.heads:
        for L in head.layers:
            w[L.row_off:L.row_off + L.fin, :L.fout] = rng.randn(
                L.fin, L.fout) * 0.3
            b[L.bias_idx, :L.fout] = rng.randn(L.fout) * 0.1
    emb = rng.randn(n, E).astype(np.float32)
    feat = rng.randn(n, feat_dim).astype(np.float32)
    gs = [rng.randn(n, h.out_dim).astype(np.float32) for h in plan.heads]
    return plan, emb, feat, w, b, gs


def _torch(plan, emb, feat, w, b, gs):
    return (plan, *map(torch.as_tensor, (emb, feat, w, b)),
            [torch.as_tensor(g) for g in gs])


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("feat_dim", [6, 0])
def test_scratch_layout_and_padding(feat_dim, dtype):
    """Blocks in plan order, back to back, 16-byte aligned in either
    type; X_0 is the rounded h_in; every padding row and column is zero."""
    n = 37
    case = _torch(*_case(feat_dim, n))
    plan, emb, feat = case[:3]
    cdt = DTYPES[dtype][1]
    lay = fm.dw_scratch_layout(plan, n)
    assert lay.n_pad == 64 and lay.n_pad % fm.ROW_ALIGN == 0
    pos = 0
    for L, xo, go in zip(fm._layers(plan), lay.x_off, lay.g_off):
        assert (xo, go) == (pos, pos + lay.n_pad * -(-L.fin // 8) * 8)
        pos = go + lay.n_pad * -(-L.fout // 8) * 8
        for off in (xo, go):
            assert off * 2 % 16 == 0 and off * 4 % 16 == 0
    assert pos == lay.size
    scratch = fm.dw_scratch_plain(*case, cdt)
    assert scratch.dtype == cdt and scratch.shape == (lay.size,)
    blocks = fm.scratch_blocks(plan, scratch, n)
    h_in = torch.cat([emb, feat], 1).to(cdt)
    torch.testing.assert_close(blocks[0][0][:n, :E + feat_dim], h_in,
                               rtol=0, atol=0)
    for L, (x, g) in zip(fm._layers(plan), blocks):
        assert x.shape == (lay.n_pad, -(-L.fin // 8) * 8)
        assert g.shape == (lay.n_pad, -(-L.fout // 8) * 8)
        for blk, width in ((x, L.fin), (g, L.fout)):
            assert not bool(blk[n:].any()) and not bool(blk[:, width:].any())
            assert bool(blk[:n, :width].any())


@pytest.mark.parametrize("slices", [1, 3, 7])
@pytest.mark.parametrize("n", [37, 293])
@pytest.mark.parametrize("feat_dim", [6, 0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dw_plain_matches_bwd_plain(dtype, feat_dim, n, slices):
    """fused_dw_plain over dw_scratch_plain, slice by slice, equals the
    plain backward's dW, padding (zero) included."""
    case = _torch(*_case(feat_dim, n))
    cdt = DTYPES[dtype][1]
    want = fm.fused_heads_bwd_plain(*case, cdt)[2]
    got = fm.fused_dw_plain(case[0], fm.dw_scratch_plain(*case, cdt), n,
                            slices)
    assert got.shape == want.shape == (case[0].n_rows, fm.COLS)
    assert _rel_err(got, want) <= 1e-6
    for L in fm._layers(case[0]):
        block = got[L.row_off:L.row_off + -(-L.fin // 8) * 8]
        assert not bool(block[L.fin:].any()) and not bool(
            block[:, L.fout:].any())


@pytest.mark.parametrize("feat_dim", [6, 0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dw_matches_jax(dtype, feat_dim):
    """The split-K dW (three slices of N = 37) and the plain backward's dW
    against the JAX custom VJP (Pallas interpret mode) on the same packed
    weights and cotangents."""
    n = 37
    plan, emb, feat, w, b, gs = _case(feat_dim, n, seed=1)
    jdt, cdt = DTYPES[dtype]
    jplan = jfm.build_plan(CFGS, emb_dim=E, feat_dim=feat_dim)
    assert tuple(plan) == tuple(jplan)
    _, vjp = jax.vjp(lambda *a: jfm.fused_heads(jplan, 32, jdt, True, *a),
                     *map(jnp.asarray, (emb, feat, w, b)))
    want = np.asarray(vjp(tuple(map(jnp.asarray, gs)))[2])
    case = _torch(plan, emb, feat, w, b, gs)
    got = fm.fused_dw_plain(plan, fm.dw_scratch_plain(*case, cdt), n, 3)
    bwd = fm.fused_heads_bwd_plain(*case, cdt)[2]
    tol = 1e-6 if dtype == "float32" else 1e-4
    assert _rel_err(got.numpy(), want) <= tol
    assert _rel_err(bwd.numpy(), want) <= tol


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("mode", list(PUBLISHED))
def test_slice_count_is_a_function_of_shapes_and_sms(mode, sms):
    """S fills at most two CTAs an SM with tiles x S, leaves no slice
    empty, and depends on N only through the padded row count."""
    plan = fm.build_plan(PUBLISHED[mode], 39, 48)
    tiles = len(fm.dw_tiles(plan))
    for n in (1, 37, 1037, 100_000):
        n_pad = fm.dw_scratch_layout(plan, n).n_pad
        s = fm.dw_slices(plan, n, sms)
        rows = fm.dw_slice_rows(n_pad, s)
        assert s == fm.dw_slices(plan, n, sms) == fm.dw_slices(
            plan, n_pad, sms)
        assert 1 <= s and (s == 1 or tiles * s <= 2 * sms)
        assert rows % fm.ROW_ALIGN == 0 and (s - 1) * rows < n_pad <= s * rows
    # the published widths at N = 100,000 on 132 SMs: 9 and 28 tiles
    assert (tiles, fm.dw_slices(plan, 100_000, 132)) == {
        "deform": (9, 29), "downstream": (28, 9)}[mode]


@pytest.mark.parametrize("feat_dim", [6, 0])
def test_dw_tiles_cover_every_packed_row_once(feat_dim):
    """fused_mlp_dw's tiles write every row of its [S, R, 128] partial
    once (its caller allocates it empty)."""
    for cfgs, e in ((CFGS, E), (PUBLISHED["downstream"], 39)):
        plan = fm.build_plan(cfgs, e, feat_dim)
        layers = fm._layers(plan)
        rows = []
        for li, m0 in fm.dw_tiles(plan):
            L = layers[li]
            rows += range(L.row_off + m0, L.row_off + min(
                m0 + fm.DW_TILE, -(-L.fin // 8) * 8))
        assert rows == list(range(plan.n_rows))
