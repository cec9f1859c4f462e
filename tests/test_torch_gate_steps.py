"""The 4-D quality gate's own training step, port against JAX on the CPU,
in the regime the gate trains in (``--variant owlii4d --num_views 4``:
the VarTriPlane field with ``n_frames`` 6, ResField rank 40 on the heads,
the offset flow head; the four views of one frame a step).

The scene, cameras and trainee are ``scripts/quality_gate_torch.py``'s
``Gate`` at the JAX gate's CPU size (``scripts/gate_parity_cpu.py``'s
``cpu_gate``: 64x64, 256 true Gaussians, 512 splats from
``create_from_pcd``, ``noise_res`` 4, ``tile_cap`` 256, ``lambda_norm``
0.01, ``lambda_mask`` 0, the gate's learning rates and view order). The
net is drawn by the port at seed 0 and carried to JAX with
``interop.module_to_flax``. JAX's ``rasterize`` goes through
``blend_sorted_pallas(..., interpret=True)``, the closed-form VJP the TPU
gate ran: the 0.99 alpha clamp's gradient is 1 there, as in the port
(JAX's CPU autodiff of its XLA blend gives 0).

One JAX program runs every case (its trace, lowering and compile, ~75 s
on one core, are half of this file's time):

- JAX's free-running gate loop from zero Adam states, with the port's
  step teacher-forced at iterations 1-6, the steps of frames 0-5 (fids 0,
  0.2, ..., 1.0), each four same-fid views: the port's step from JAX's
  state after k - 1 against JAX's after k;
- the default ``dup_factor`` 5 (a 2,560-row budget): the untrained field
  overflows it, so the first step drops instances (asserted, the same
  count in both packages);
- the encoder (VarTriPlane's plane CNN), the ResField coefficients and
  the flow head inside the step, their gradients held with the rest;
- one state past the clamp: JAX's state after iteration ``CLAMP_AT``
  with the opacity head's last bias raised by ``CLAMP_LOGIT`` (before its
  sigmoid), so that >= 1% of the instances the blend applies reach the
  clamp at some pixel (asserted).

The bounds are tests/test_torch_4d.py's: the loss within rtol 1e-6, its
parts within rtol 1e-5, radii, visibility counts, the valid mask and the
dropped count equal, the screen-space gradient and the accumulated
statistics within 1e-5 of the screen gradient's largest value, the Adam
moments within 1e-5 of each leaf's largest value, the parameters within
rtol 1e-6 plus 1e-4 of the leaf's learning rate, through
``gate_parity_cpu.hold``. Of ``hold``'s routes for ill-conditioned
leaves, this trajectory may use only these, each asserted
(``problems``):

- rounding level: leaves whose gradient is zero in exact arithmetic (a
  conv bias whose GroupNorm subtracts it again, the rows behind a
  zero-initialised conv), below 1e-6 of the step's largest field
  gradient in both packages;
- the gradient bound of tests/test_torch_4d.py, for the rotation head's
  leaves alone (their cotangent is ~5e-4 of the means' and cancels for
  near-isotropic splats);
- Adam near a zero second moment (the first steps' sign-like updates):
  the port's parameter held to JAX's own ``adam_update`` fed the port's
  gradient, for at most ``ADAM_MAX`` leaves a step, the gradient held by
  the moments;
- no kink.

Two witnesses must fail: a head whose backward passes 1.001 of its
gradient (inside the net, so the float64 copy ``hold`` probes carries
it), and ``train_lib.field_attributes`` passing 1.001 of the colour's
cotangent to the net (outside it). The static field step is held by
tests/test_torch_train.py (its encoder included), its gate trajectory by
``scripts/gate_parity_cpu.py``'s teacher-forced runs.
"""
import os
import sys

import numpy as np
import pytest
import torch

from splatfields_torch import train_lib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import gate_parity_cpu as gate_parity  # noqa: E402

VARIANT, NUM_VIEWS = "owlii4d", 4
FORCED = (1, 2, 3, 4, 5, 6)      # teacher-forced: frames 0-5
CLAMP_AT, CLAMP_LOGIT = max(FORCED), 8.0
WITNESS_AT = max(FORCED)
ADAM_MAX = 32
LOSS_RTOL = 1e-6    # tests/test_torch_4d.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a full torch thread pool in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def forced_step(port, before, after, batch, j_out):
    """One teacher-forced step and ``hold``'s verdict, as a dict."""
    step = gate_parity.teacher_step(port, before, after, batch)
    failures, notes = gate_parity.hold(port, step, batch)
    return {"step": step, "failures": failures, "notes": notes,
            "j_out": j_out, "batch": batch, "before": before,
            "after": after}


@pytest.fixture(scope="module")
def runs():
    """JAX's gate loop with the port's step teacher-forced at ``FORCED``
    -> {iteration: ``forced_step``}; "clamp": one step from JAX's state
    after ``CLAMP_AT`` lifted past the clamp, its ``clamp_share`` under
    "share"; "port": the port's run (its net and pipeline)."""
    with pytest.MonkeyPatch.context() as mp:
        gate_parity.jax_blend_pallas(mp)
        gate = gate_parity.cpu_gate(VARIANT, 0, num_views=NUM_VIEWS)
        port = gate_parity.PortRun(gate)
        jx = gate_parity.JaxRun(gate, port.deform.net)
        gate_parity.same_splats(port, jx)
        out = {"port": port}
        for it in range(1, max(FORCED) + 1):
            b = gate_parity.group_batch(gate, (it - 1) % len(gate.groups))
            before = jx.state
            j_out = jx.step(b)
            out[it] = forced_step(port, before, jx.state, b, j_out)
        # JAX's state after the last forced iteration, past the clamp
        lifted = gate_parity.past_clamp(jx.state, CLAMP_LOGIT)
        nb = gate_parity.group_batch(gate, CLAMP_AT % len(gate.groups))
        share = gate_parity.clamp_share(
            port, gate_parity.port_state_from_jax(lifted), nb)
        jx.params, jx.stats, jx.sopt, fp, jx.fopt = gate_parity.jax_tree(
            lifted)
        jx.fvars = dict(jx.fvars, params=fp)
        c_out = jx.step(nb)
        out["clamp"] = dict(forced_step(port, lifted, jx.state, nb, c_out),
                            share=share)
    return out


def problems(run):
    """``hold``'s failures, and its exemption routes past what this
    trajectory may use -> [(leaf or route, what)]."""
    notes = run["notes"]
    out = [(leaf, what) for leaf, what, _ in run["failures"]]
    out += [(leaf, "kink") for leaf in notes["kink"]]
    out += [(leaf, "gradient route") for leaf in notes["gradient"]
            if not leaf.startswith(gate_parity.ROTATION_HEAD)]
    if len(notes["adam"]) > ADAM_MAX:
        out.append(("adam", f"{len(notes['adam'])} leaves"))
    return out


def check_step(run):
    """Everything but the leaves at tests/test_torch_4d.py's bounds (loss
    and its parts, means, dropped count, radii, screen gradient,
    statistics), then ``hold``'s verdict on every leaf and its routes."""
    step, j_out = run["step"], run["j_out"]
    p_out = step["out"]
    np.testing.assert_allclose(float(p_out.loss), float(j_out.loss),
                               rtol=LOSS_RTOL)
    assert set(p_out.loss_dict) == set(j_out.loss_dict)
    for k in j_out.loss_dict:
        np.testing.assert_allclose(p_out.loss_dict[k].numpy(),
                                   np.asarray(j_out.loss_dict[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(p_out.means3d.numpy(),
                               np.asarray(j_out.means3d), rtol=1e-5,
                               atol=1e-5)
    assert int(p_out.loss_dict["bin_dropped"]) == \
        int(j_out.loss_dict["bin_dropped"])
    np.testing.assert_array_equal(p_out.radii.numpy(),
                                  np.asarray(j_out.radii))
    sg = np.asarray(j_out.screen_grad)
    scale = np.abs(sg).max()
    assert scale > 0
    np.testing.assert_allclose(p_out.screen_grad.numpy() / scale,
                               sg / scale, atol=1e-5, rtol=0)
    p_st, j_st = step["stats"]
    for k in ("valid", "max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(p_st, k).numpy(),
                                      np.asarray(getattr(j_st, k)), k)
    np.testing.assert_allclose(p_st.xyz_gradient_accum.numpy() / scale,
                               np.asarray(j_st.xyz_gradient_accum) / scale,
                               atol=1e-5, rtol=0)
    assert set(step["got"]) == set(step["want"])
    assert problems(run) == [], (
        problems(run), {k: len(v) for k, v in run["notes"].items()})


@pytest.mark.parametrize("it", FORCED)
def test_teacher_forced_step(runs, it):
    check_step(runs[it])


def test_every_frame_forced(runs):
    """One forced step at each frame, each of four views of its frame."""
    frames = set()
    for it in FORCED:
        b = runs[it]["batch"]
        assert b["image"].shape[0] == NUM_VIEWS == len(b["tanfovx"])
        frames.add(round(b["fid"] * 5))
    assert frames == set(range(6))


def test_first_step_drops_instances(runs):
    p_out, j_out = runs[1]["step"]["out"], runs[1]["j_out"]
    dropped = int(j_out.loss_dict["bin_dropped"])
    assert dropped > 0
    assert int(p_out.loss_dict["bin_dropped"]) == dropped


def test_encoder_gradient_held(runs):
    """The plane CNN's, the ResField coefficients' and the flow head's
    gradients are in the step and held (not at rounding level) once the
    zero-initialised convs have moved."""
    run = runs[CLAMP_AT]
    held = [k for k in run["step"]["g_want"]
            if k.startswith("field.") and k not in
            run["notes"]["rounding level"]]
    assert sum(k.startswith("field.encoder.") for k in held) > 100
    assert any(k.endswith(".weights_t") for k in held)
    assert any(k.endswith(".matrix_t") for k in held)
    assert any(k.startswith("field.mlp_flow") for k in held)


def test_step_past_the_clamp(runs):
    run = runs["clamp"]
    rows, pairs = run["share"]
    assert rows >= 0.01 and pairs > 0, (rows, pairs)
    check_step(run)


def scaled_head(port, head):
    """The port's ``head`` passes back 1.001 of its output's gradient,
    forward unchanged (the float64 copy ``hold`` probes carries it)."""
    return getattr(port.deform.net, head).register_forward_hook(
        lambda m, i, o: o + 1e-3 * (o - o.detach()))


def scaled_colour(monkeypatch):
    """``train_lib.field_attributes`` passes 1.001 of the colour's
    cotangent back to the net, values unchanged (outside the net)."""
    attributes = train_lib.field_attributes

    def faulty(*args, **kw):
        out = attributes(*args, **kw)
        if torch.is_grad_enabled():
            rgb = out["rgb"]
            out["rgb"] = rgb + 1e-3 * (rgb - rgb.detach())
        return out

    monkeypatch.setattr(train_lib, "field_attributes", faulty)


@pytest.mark.parametrize("fault", ["mlp_rgb", "field_attributes"])
def test_hold_catches_a_gradient_fault(runs, fault, monkeypatch):
    """The step at ``WITNESS_AT`` again with a 1.001 gradient fault:
    ``problems`` must name a colour head leaf's moments. The fault does
    not move with the state, so ``grad_jump`` does not take it for a
    kink, and the port's float64 gradient (which the fault outside the
    net does not reach) does not widen the bound."""
    port, run = runs["port"], runs[WITNESS_AT]
    assert problems(run) == []
    handle = None
    if fault == "field_attributes":
        scaled_colour(monkeypatch)
    else:
        handle = scaled_head(port, fault)
    try:
        faulty = forced_step(port, run["before"], run["after"],
                             run["batch"], run["j_out"])
    finally:
        if handle is not None:
            handle.remove()
    assert any(leaf.startswith("field.mlp_rgb.") and what == "moments"
               for leaf, what in problems(faulty)), problems(faulty)
