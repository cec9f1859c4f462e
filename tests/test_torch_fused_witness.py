"""chip_smoke.layer_witness, the layer-by-layer check of the bf16 fused
kernels, on the CPU without JAX: the plain version's own results pass it
(its f32 sums are another order of the same products), and a wrong value
of the kinds a kernel bug would give (a point's row from another point, a
lost or wrong leaky mask, a stale skip copy, a dirty pad, an off gradient
row, a wrong output) fails it.
"""
import functools

import pytest
import torch

from chip_smoke import TOL_LAYER, fused_case, layer_witness
from splatfields_torch.ops import fused_mlp as fm

BF16 = torch.bfloat16
CPU = torch.device("cpu")


@functools.cache
def _plain(kind, n):
    """A fused case and the plain version's results in the kernels' form:
    (case, outs, d_emb, d_feat, scratch, db)."""
    case = fused_case(kind, CPU, n=n)
    plan, emb, feat, w, b, gs = case
    with torch.no_grad():
        outs = fm.fused_heads_plain(plan, emb, feat, w, b, BF16)
    d_emb, d_feat, _, db = fm.fused_heads_bwd_plain(*case, BF16)
    scratch = fm.dw_scratch_plain(*case, BF16)
    return case, outs, d_emb, d_feat, scratch, db


def _witness(case, outs, d_emb, d_feat, scratch, db):
    return layer_witness(*case, outs, d_emb, d_feat, scratch, db)


@pytest.mark.parametrize("kind", ["deform", "ragged", "no_features",
                                  "skip_last_but_one"])
def test_plain_version_passes(kind):
    st = _witness(*_plain(kind, 300))
    assert st["values"] > 0
    assert st["gap"] <= TOL_LAYER
    # another order flips few roundings
    assert st["flips"] <= 1e-3 * st["values"]


def _mutate(what):
    case, outs, d_emb, d_feat, scratch, db = _plain("ragged", 300)
    plan = case[0]
    outs, d_emb, scratch = [o.clone() for o in outs], d_emb.clone(), (
        scratch.clone())
    blocks = fm.scratch_blocks(plan, scratch, 300)
    if what == "x_row_of_another_point":     # layer 2 of the first head
        blocks[2][0][7] = blocks[2][0][8]
    elif what == "x_value_off_by_a_step":    # the next bf16 value
        bits = blocks[1][0].view(torch.int16)
        bits[3, 5] += 1
    elif what == "lost_mask":                # a negative output's cotangent
        head0 = len(plan.heads[0].layers)
        X, G = blocks[head0 - 1]
        L = plan.heads[0].layers[head0 - 2]
        Xout = X[:300, :L.fout]
        p, c = (Xout < 0).nonzero()[0].tolist()
        Gp = blocks[head0 - 2][1]
        Gp[p, c] = (Gp[p, c].float() / fm.ALPHA).to(BF16)
    elif what == "stale_skip_copy":          # h_in after the skip
        L = plan.heads[0].layers
        j = next(i for i, l in enumerate(L) if l.skip_after)
        blocks[j + 1][0][11, 0] += 1
    elif what == "dirty_pad":
        X = blocks[0][0]
        X[5, X.shape[1] - 1] = 1
    elif what == "d_emb":
        d_emb[4, 2] += 1e-3 * float(d_emb.abs().max())
    elif what == "output":
        outs[1][9, 0] += 1e-3 * float(outs[1].abs().max())
    else:
        raise ValueError(what)
    return case, outs, d_emb, d_feat, scratch, db


@pytest.mark.parametrize("what", ["x_row_of_another_point",
                                  "x_value_off_by_a_step", "lost_mask",
                                  "stale_skip_copy", "dirty_pad", "d_emb",
                                  "output"])
def test_wrong_values_fail(what):
    with pytest.raises(AssertionError):
        _witness(*_mutate(what))
