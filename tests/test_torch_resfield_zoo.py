"""The rest of the ResField zoo against the JAX package on the CPU: every
(compression, mode, fuse_mode) combination that the JAX ``ResFieldLinear``
accepts, chunked ``vm`` with each strategy, and the options
(``coeff_ratio``, ``ignore_residuals``, ``lock_weights``), at in=8,
out=6, capacity 4, rank 3.

The parameters are the port's tree in flax's layout
(``interop.module_to_flax``; no flax init runs) redrawn as N(0, 0.3)
numpy draws (a SIREN's as small uniform ones), carried to the port with
``interop``; the port's own parameters carried back with
``interop.module_to_flax`` equal them. Outputs and the gradients of a
fixed random cotangent (every parameter, the input, and the time and the
coordinates where the member reads them) agree within 1e-6 relative plus
1e-6 of the largest JAX value of their tree (the outputs, or all the
gradients), as in tests/test_torch_resfields.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from splatfields_tpu.models import resfields as jax_resfields
from splatfields_torch.interop import (
    flax_to_state_dict,
    load_flax_variables,
    module_to_flax,
)
from splatfields_torch.models import resfields

IN, OUT, CAP, RANK, N, FRAME = 8, 6, 4, 3, 5, 2
# chip_smoke.py's phase 39 runs the same members on the card
COMBOS = chip_smoke.ZOO_CASES
OPTIONS = (
    ("vm", "lookup", "add", {"coeff_ratio": 0.5}),        # frame 2 clamps
    ("vm", "interpolation", "add", {"coeff_ratio": 0.5}),
    ("cp", "lookup", "mul", {"ignore_residuals": True}),
    ("vm", "lookup", "add", {"lock_weights": True}),
    ("tucker", "lookup", "add", {"lock_weights": True}),
    ("lora_3", "lookup", "add", {"lock_weights": True}),
)


def _id(case):
    c, m, f, kw = case
    return "-".join([c, m, f] + [f"{k}={v}" for k, v in kw.items()])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (see tests/test_torch_owlii.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(compression, mode):
    """(args, JAX kwargs, port kwargs, names of the inputs differentiated)
    for the member's way of reading time."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, IN).astype(np.float32)
    arrays = {"x": x}
    jkw, tkw = {}, {}
    if compression.startswith("lora"):
        arrays["coordinates"] = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    elif mode == "lookup":
        jkw["frame_id"], tkw["frame_id"] = jnp.int32(FRAME), FRAME
    else:   # two times past the ends: clamped to the first and last row
        t = rng.uniform(-1, 1, (N, 1)).astype(np.float32)
        t[0, 0], t[1, 0] = -1.25, 1.25
        arrays["input_time"] = t
    return arrays, jkw, tkw


def _draw(shapes, seed):
    """A parameter tree of the flax shapes: N(0, 0.3) draws, but U(-1,
    1) / fan_in in a SIREN (its sin(30 x) needs small weights)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if any(getattr(p, "key", None) == "weights_t_siren" for p in path):
            fan_in = s.shape[0] if len(s.shape) == 2 else 128
            return (rng.uniform(-1, 1, s.shape) / fan_in).astype(np.float32)
        return (0.3 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, what, scale):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                               atol=1e-6 * scale, err_msg=what)


def _parity(compression, mode, fuse, kw, seed=0):
    if "chunk_size" in kw:   # None: half the capacity
        kw = dict(kw, chunk_size=kw["chunk_size"] or CAP // 2)
    cfg = dict(rank=RANK, capacity=CAP, mode=mode, compression=compression,
               fuse_mode=fuse, **kw)
    jm = jax_resfields.ResFieldLinear(in_features=IN, out_features=OUT, **cfg)
    pm = resfields.ResFieldLinear(IN, OUT, **cfg,
                                  generator=torch.Generator().manual_seed(0))
    arrays, jkw, tkw = _inputs(compression, mode)
    x = arrays.pop("x")
    # the port's tree in flax's layout, redrawn: JAX's apply takes it only
    # if every name and shape is flax's
    params = _draw(module_to_flax(pm)["params"], seed)
    load_flax_variables(pm, {"params": params})
    back = flax_to_state_dict(module_to_flax(pm)["params"])
    for k, v in flax_to_state_dict(params).items():   # and back again
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)

    cot = np.random.RandomState(seed + 1).randn(N, OUT).astype(np.float32)
    names = list(arrays)

    def loss(p, x_, *extra):
        o = jm.apply({"params": p}, x_, **jkw, **dict(zip(names, extra)))
        return jnp.sum(o * cot), o

    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(2 + len(names))), has_aux=True))(
            params, x, *[arrays[n] for n in names])
    want = np.asarray(want)

    x_t = torch.tensor(x, requires_grad=True)
    extra_t = {n: torch.tensor(arrays[n], requires_grad=True) for n in names}
    got = pm(x_t, **tkw, **extra_t)
    scale = float(np.abs(want).max())
    _close(got, want, "output", scale)
    leaves = dict(pm.named_parameters())
    g = torch.autograd.grad((got * torch.tensor(cot)).sum(),
                            list(leaves.values()) + [x_t]
                            + list(extra_t.values()), allow_unused=True)
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, grads[0]))
    assert set(leaves) == set(want_g)
    want_in = [np.asarray(w) for w in grads[1:]]
    g_scale = max(float(np.abs(w.numpy()).max()) for w in want_g.values())
    g_scale = max([g_scale] + [float(np.abs(w).max()) for w in want_in])
    for (k, _), gk in zip(leaves.items(), g):
        gk = torch.zeros_like(leaves[k]) if gk is None else gk
        _close(gk, want_g[k].numpy(), k, g_scale)
    for name, gk, w in zip(["x"] + names, g[len(leaves):], want_in):
        _close(torch.zeros(w.shape) if gk is None else gk, w, name, g_scale)
    return pm, g, leaves


@pytest.mark.parametrize("case", COMBOS, ids=[_id(c) for c in COMBOS])
def test_zoo_member_matches_jax(case):
    _parity(*case)


@pytest.mark.parametrize("case", OPTIONS, ids=[_id(c) for c in OPTIONS])
def test_zoo_options_match_jax(case):
    pm, grads, leaves = _parity(*case, seed=3)
    c, _, _, kw = case
    weight_grad = grads[list(leaves).index("weight")]
    if kw.get("lock_weights") and not c.startswith("lora"):
        assert weight_grad is None or not weight_grad.any()
    else:   # the lora members' shared Linear reads the weight unlocked
        assert weight_grad is not None and weight_grad.abs().sum() > 0


def test_trilinear_sample_border_is_grid_sample():
    """``trilinear_sample_border`` against JAX and torch's grid_sample
    (bilinear, border, align_corners) on points inside and outside."""
    rng = np.random.RandomState(4)
    vol = rng.randn(5, 3, 4, 6).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (17, 3)).astype(np.float32)
    got = resfields.trilinear_sample_border(torch.tensor(vol),
                                            torch.tensor(coords))
    want = jax_resfields._trilinear_sample_border(vol, coords)
    _close(got, want, "jax", 1.0)
    ref = torch.nn.functional.grid_sample(
        torch.tensor(vol)[None], torch.tensor(coords)[None, :, None, None],
        mode="bilinear", padding_mode="border", align_corners=True)
    _close(got, ref[0, :, :, 0, 0].T, "grid_sample", 1.0)


@pytest.mark.parametrize("case", [("loe", "lookup", {}),
                                  ("vm", "interpolation",
                                   {"chunk_size": 2})])
def test_zoo_refusals_match_jax(case):
    """What the JAX layer refuses, the port refuses: ``loe`` by frame
    lookup, chunked ``vm`` without a frame."""
    c, mode, kw = case
    x = np.ones((N, IN), np.float32)
    t = np.zeros((N, 1), np.float32)
    jm = jax_resfields.ResFieldLinear(in_features=IN, out_features=OUT,
                                      rank=RANK, capacity=CAP, mode=mode,
                                      compression=c, **kw)
    with pytest.raises(NotImplementedError):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, input_time=t)
    pm = resfields.ResFieldLinear(IN, OUT, RANK, CAP, mode, c, **kw,
                                  generator=torch.Generator())
    with pytest.raises(NotImplementedError):
        pm(torch.tensor(x), input_time=torch.tensor(t))
