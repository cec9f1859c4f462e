"""The Moran regularizers of the port's training step
(``train_lib.corr_term`` in ``compute_losses``) against
``splatfields_tpu.train_lib`` on the CPU.

``compute_losses`` on fixed render outputs (a 16x16 colour per view, two
views, D-SSIM 0.2) and attribute leaves of 300 splats, 30 of them
invalid, in static mode (SH features) and field mode (rgb): the loss and
its gradient with respect to every attribute, for ``lambda_corr``,
``lambda_corr_color`` (weighted by ``lambda_corr``, the reference's
quirk) and ``--corr_interval`` with the gate on (the term times the
interval) and off (no term). Tolerances: the KNN weights agree to ~1e-7
relative (tests/test_torch_knn.py), so the loss gets rtol 1e-6 and each
gradient 1e-6 of its leaf's largest value.

One static training step with ``lambda_corr`` 0.01 against
``make_train_step``, with tests/test_torch_train.py's harness, tolerances
and non-zero Adam states, on 256 splats of which 32 are marked invalid,
as pruning leaves them (parked before the KNN, their neighbourhoods
masked), one JAX compile shared by the tests through a module fixture.
"""
import dataclasses
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_torch import config, train_lib
from splatfields_torch.interop import (
    adam_state_from_numpy,
    splat_params_from_numpy,
)
from splatfields_torch.models import splats
from splatfields_tpu import config as jax_config
from splatfields_tpu import train_lib as jax_train_lib
from splatfields_tpu.models import splats as jax_splats
from tests.test_torch_train import (
    FIELD_LR,
    H,
    SPLAT_LRS,
    W,
    _batches,
    _moments,
    _np,
    check_adam_states,
    check_loss_and_aux,
    check_parameters,
    check_screen_grad_radii_and_stats,
)

Out = namedtuple("Out", "color")
N_ATTR, N_INVALID = 300, 30


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(mode, seed=0):
    rng = np.random.RandomState(seed)
    n = N_ATTR
    attrs = {
        "means3d": rng.uniform(-1, 1, (n, 3)),
        "scales": rng.uniform(0.01, 0.1, (n, 3)),
        "rotations": rng.randn(n, 4),
        "opacity": rng.uniform(0.05, 0.95, n),
    }
    if mode == "static":
        attrs["shs"] = rng.randn(n, 16, 3) * 0.3
    else:
        attrs["rgb"] = rng.uniform(0, 1, (n, 3))
    attrs = {k: v.astype(np.float32) for k, v in attrs.items()}
    valid = np.ones(n, bool)
    valid[rng.choice(n, N_INVALID, replace=False)] = False
    colors = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    images = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    return attrs, valid, colors, images


CASES = {
    # lambda_corr, lambda_corr_color, corr_interval, gate
    "corr": (0.01, 0.0, 1, None),
    "corr_and_color": (0.01, 0.02, 1, None),
    "color_only": (0.0, 0.05, 1, None),
    "interval_on": (0.01, 0.02, 3, True),
    "interval_off": (0.01, 0.02, 3, False),
}


@pytest.mark.parametrize("mode,case", [
    *(("static", c) for c in sorted(CASES)),
    ("field", "corr"), ("field", "corr_and_color")])
def test_compute_losses(mode, case):
    lc, lcc, interval, gate = CASES[case]
    kw = dict(lambda_mask=0.0, lambda_corr=lc, lambda_corr_color=lcc,
              corr_interval=interval)
    attrs, valid, colors, images = _inputs(mode)
    j_opt = jax_config.OptimizationConfig(**kw)
    p_opt = config.OptimizationConfig(**kw)
    j_batch = {"image": jnp.asarray(images)}
    p_batch = {"image": torch.as_tensor(images)}
    if gate is not None:
        j_batch["corr_gate"] = jnp.float32(1.0 if gate else 0.0)
        p_batch["corr_gate"] = gate

    def j_loss(a, c):
        outs = [Out(c[0]), Out(c[1])]
        return jax_train_lib.compute_losses(outs, j_batch, a, j_opt,
                                            jnp.asarray(valid))[0]

    j_val, (j_ga, j_gc) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in attrs.items()}, jnp.asarray(colors))
    p_attrs = {k: torch.tensor(v, requires_grad=True)
               for k, v in attrs.items()}
    p_colors = torch.tensor(colors, requires_grad=True)
    outs = [Out(p_colors[0]), Out(p_colors[1])]
    p_val, _ = train_lib.compute_losses(
        outs, p_batch, dict(p_attrs, valid=torch.as_tensor(valid)), p_opt,
        torch.as_tensor(valid))
    names = list(p_attrs)
    grads = torch.autograd.grad(p_val, [p_attrs[k] for k in names]
                                + [p_colors], allow_unused=True)
    np.testing.assert_allclose(float(p_val.detach()), float(j_val),
                               rtol=1e-6)
    want = {**{k: np.asarray(j_ga[k]) for k in names},
            "colors": np.asarray(j_gc)}
    for name, g in zip(names + ["colors"], grads):
        w = want[name]
        got = np.zeros_like(w) if g is None else g.numpy()
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(got / scale, w / scale, atol=1e-6,
                                   rtol=0, err_msg=name)
    # the term reaches the features it regularizes (positions detached)
    moved = np.abs(want["scales"]).max() > 0
    assert moved == ((lc > 0) and gate is not False)
    assert np.abs(want["means3d"]).max() == 0


def test_gated_off_step_runs_no_knn(monkeypatch):
    attrs, valid, colors, images = _inputs("static")
    calls = []
    monkeypatch.setattr(train_lib.knn_ops, "query_nn",
                        lambda *a, **k: calls.append(1))
    opt = config.OptimizationConfig(lambda_mask=0.0, lambda_corr=0.01,
                                    corr_interval=4)
    train_lib.compute_losses(
        [Out(torch.as_tensor(colors[0]))],
        {"image": torch.as_tensor(images), "corr_gate": False},
        {k: torch.as_tensor(v) for k, v in attrs.items()}, opt,
        torch.as_tensor(valid))
    assert not calls


N_SPLATS, N_PRUNED = 256, 32


@pytest.fixture(scope="module")
def snaps():
    """One static step with lambda_corr 0.01 in both packages."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (N_SPLATS, 3)).astype(np.float32)
    cols = rng.rand(N_SPLATS, 3).astype(np.float32)
    j_params, j_stats = jax_splats.create_from_pcd(pts, cols, 0)
    valid = np.ones(N_SPLATS, bool)
    valid[rng.choice(N_SPLATS, N_PRUNED, replace=False)] = False
    j_stats = dataclasses.replace(j_stats, valid=jnp.asarray(valid))
    kw = dict(lambda_mask=0.0, lambda_norm=0.01, lambda_corr=0.01)
    mu, nu = _moments(_np(j_params), 1)
    j_sopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    j_fopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu={},
                                  nu={})
    j_step = jax_train_lib.make_train_step(
        None, jax_config.OptimizationConfig(**kw),
        jax_config.PipelineConfig(tile_cap=256, k_chunk=64), W, H, 1, False,
        0, 0)
    p_params = splat_params_from_numpy(_np(j_params), device="cpu")
    p_stats = splats.SplatStats(*[torch.tensor(np.asarray(x)) for x in (
        j_stats.valid, j_stats.max_radii2d, j_stats.xyz_gradient_accum,
        j_stats.denom)])
    p_sopt = adam_state_from_numpy(_np(j_sopt), device="cpu")
    p_fopt = adam_state_from_numpy(_np(j_fopt), device="cpu")
    p_step = train_lib.make_train_step(
        None, config.OptimizationConfig(**kw),
        config.PipelineConfig(tile_cap=256, k_chunk=64), W, H, 1, False, 0,
        0)
    assert int(p_stats.valid.sum()) == N_SPLATS - N_PRUNED
    with torch.no_grad():
        attrs = train_lib.static_attributes(p_params, p_stats.valid)
    assert float(attrs["opacity"].max()) < 0.99   # below the alpha clamp
    b = _batches(n_steps=1)[0]
    j_params, j_stats, j_sopt, j_fp, j_fopt, j_out, _ = j_step(
        j_params, j_stats, j_sopt, {"params": {}}, j_fopt,
        {k: jnp.asarray(v) for k, v in b.items()},
        jax_splats.splat_lr_tree(*SPLAT_LRS),
        jnp.asarray(FIELD_LR, jnp.float32), jax.random.PRNGKey(0))
    p_params, p_stats, p_sopt, p_fp, p_fopt, p_out = p_step(
        p_params, p_stats, p_sopt, {}, p_fopt,
        {k: torch.as_tensor(v) for k, v in b.items()},
        splats.splat_lr_tree(*SPLAT_LRS), FIELD_LR)
    return {1: dict(
        jax=dict(params=_np(j_params), stats=_np(j_stats), sopt=_np(j_sopt),
                 fparams=_np(j_fp), fopt=_np(j_fopt), out=_np(j_out)),
        port=dict(params=p_params, stats=p_stats, sopt=p_sopt, fparams=p_fp,
                  fopt=p_fopt, out=p_out))}


def test_step_loss_and_stats(snaps):
    check_loss_and_aux(snaps, 1)
    check_screen_grad_radii_and_stats(snaps, 1)


@pytest.mark.parametrize("tree", ["params", "sopt_mu", "sopt_nu"])
def test_step_parameters_and_moments(snaps, tree):
    if tree == "params":
        check_parameters("static", snaps, 1, tree)
    else:
        check_adam_states(snaps, 1, tree)
