"""The PSNR quality gate's training loop through both packages on the CPU:
``splatfields_tpu.train_lib.make_train_step`` (JAX) and
``splatfields_torch.train_lib.make_train_step`` (the port), from the same
weights, the same splats and the same scene.

The scene and trainee are ``scripts/quality_gate_torch.py``'s ``Gate``,
the builder the card's gate and ``chip_smoke.py``'s phase 47 use (the
JAX gate's cameras, ``scene_spec`` and ``cloud_at``: 8 train views, 2
held out; with ``owlii4d`` and ``num_views`` N > 1, N views of a frame a
step), on the CPU: the scene rendered once with the port's plain blend
and handed to both packages; ``create_from_pcd`` of a uniform cloud (both
packages' checked equal, then the port starts from JAX's bit for bit);
the gate's ``HiddenConfig`` with ``noise_res`` 4 (the JAX gate's CPU
size; 20 is its TPU size) for the plane variants, ``lambda_norm`` 0.01,
``lambda_mask`` 0, ``tile_cap`` 256 (its TPU size: 1024), ``dup_factor``
5, the gate's learning rates and view order. The net is drawn by the
port at seed 0 for every scene seed, as the JAX gate builds its net at
seed 0 (``scripts/quality_gate.py``), and carried to JAX with
``interop.module_to_flax``. ``SPLATFIELDS_MLP_BF16`` is off in both
packages unless the environment sets it.

JAX's blend is the Pallas kernel in interpret mode: the closed-form VJP
the TPU gate ran, with the 0.99 alpha clamp's gradient at 1 as in the
port (JAX's CPU default, autodiff of its XLA blend, gives 0 there).

Every 50 iterations (and at the last) both packages render the held-out
views with their own renderers; the script prints both PSNRs and their
gap, and at the end one JSON line with each seed's final pair and the
mean, sample standard deviation and standard error of port - JAX, and
whether they agree (|mean| within two standard errors or 0.3 dB).

``--teacher K``: every K iterations the port's step also runs from JAX's
state before that iteration (the same splats, field, Adam states and
statistics); the script prints, by leaf group, the largest gap of the
step's gradient relative to the group's largest and of the parameters in
learning rates, and ``hold``'s verdict at the step tests' bounds (the
leaves it failed, and how many it held at rounding level, by the
gradient, as a kink or through Adam). A port fault shows as a failed
leaf however the loops drift; the free-running PSNRs part by ~1 dB at a
seed from rounding alone.

    python3 scripts/gate_parity_cpu.py --variant owlii4d --seeds 0,1,2,3,4
        [--iters 300] [--res 64] [--n_splats 512] [--n_true 256]
        [--noise_res 4] [--tile_cap 256] [--teacher 25] [--threads 1]

CPU only; it imports both packages (JAX on its CPU backend).
"""
import argparse
import json
import math
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("SPLATFIELDS_MLP_BF16", "off")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import quality_gate_torch as qg  # noqa: E402

SPLAT_LRS, FIELD_LR = qg.SPLAT_LRS, qg.FIELD_LR
TILE_CAP = 256
EVAL_EVERY = 50


def cpu_gate(variant, seed, res=64, n_true=256, n_splats=512, noise_res=4,
             num_views=1, tile_cap=TILE_CAP):
    """``quality_gate_torch.Gate`` on the CPU, at the JAX gate's CPU size
    by default (its TPU size: 400, 3,000, 20,000, 20, 1,024)."""
    import torch
    return qg.Gate(variant, seed, torch.device("cpu"), res=res,
                   n_true=n_true, n_splats=n_splats, noise_res=noise_res,
                   tile_cap=tile_cap, num_views=num_views)


def group_batch(gate, g):
    """The port's batch of the gate's train group ``g``."""
    import torch
    return gate.batch(gate.groups[g], torch.device("cpu"))


def jax_batch(b):
    """A port batch (``Gate.batch``) as JAX's step takes it."""
    import jax.numpy as jnp
    m = len(b["tanfovx"])
    out = {k: b[k].numpy() for k in ("viewmatrix", "projmatrix", "campos",
                                     "image", "bg")}
    out.update(tanfovx=np.array(b["tanfovx"], np.float32),
               tanfovy=np.array(b["tanfovy"], np.float32),
               fid=np.float32(b["fid"]),
               mask=np.zeros((m, 1, 1, 1), np.float32),
               depth=np.zeros((m, 1, 1), np.float32))
    return {k: jnp.asarray(v) for k, v in out.items()}


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


class PortRun:
    """The port's trainee and step on the CPU."""

    def __init__(self, gate):
        import torch

        from splatfields_torch.models import splats
        self.gate = gate
        self.params, self.stats, self.sopt, self.deform = gate.trainee(
            torch.device("cpu"))
        self.fparams, self.fopt = self.deform.params, self.deform.opt_state
        self.pipe = gate.pipe
        self.step_fn = gate.train_step(self.deform.net)
        self.lrs = splats.splat_lr_tree(*SPLAT_LRS)

    def run_step(self, state, b):
        """One step from ``state`` = (params, stats, sopt, fparams, fopt)
        -> (new state, StepOut)."""
        *new, out = self.step_fn(*state, b, self.lrs, FIELD_LR)
        return tuple(new), out

    @property
    def state(self):
        return (self.params, self.stats, self.sopt, self.fparams, self.fopt)

    def step(self, b):
        state, out = self.run_step(self.state, b)
        (self.params, self.stats, self.sopt, self.fparams,
         self.fopt) = state
        return out

    def psnr(self):
        import torch

        from splatfields_torch.ops.ssim import psnr as psnr_fn
        from splatfields_torch.render_lib import render_camera
        self.deform.params = self.fparams
        vals = []
        with torch.no_grad():
            for v in self.gate.test_v:
                img = render_camera(self.gate.cams[v], self.params,
                                    self.stats, self.deform, self.pipe,
                                    np.zeros(3, np.float32),
                                    n_frames=self.gate.n_frames)["render"]
                gt = self.gate.gts[v]
                vals.append(float(psnr_fn(torch.clamp(img, 0, 1),
                                          torch.clamp(gt, 0, 1))))
        return float(np.mean(vals))


def jax_blend_pallas(monkeypatch=None):
    """Route JAX's ``rasterize`` through the Pallas blend in interpret
    mode (the TPU gate's kernel and its closed-form VJP). With a pytest
    ``monkeypatch`` the change is undone after the test."""
    import functools

    from splatfields_tpu.ops.raster import api as japi
    from splatfields_tpu.ops.raster import blend_pallas
    kernel = functools.partial(blend_pallas.blend_sorted_pallas,
                               interpret=True)

    def pallas(*a, **k):
        return kernel(*a[:8])

    if monkeypatch is not None:
        monkeypatch.setattr(japi, "default_blend_impl", lambda: "pallas")
        monkeypatch.setattr(japi, "blend_sorted_pallas", pallas)
    else:
        japi.default_blend_impl = lambda: "pallas"
        japi.blend_sorted_pallas = pallas


_JAX_STEPS = {}


class JaxRun:
    """JAX's trainee (the port's net carried over) and step on the CPU."""

    def __init__(self, gate, port_net):
        import jax
        import jax.numpy as jnp

        from splatfields_torch.interop import module_to_flax
        from splatfields_tpu import config as jcfg
        from splatfields_tpu import train_lib as jtrain
        from splatfields_tpu.models import splats as jsplats
        from splatfields_tpu.models.deform_model import build_splatfields
        self.gate = gate
        self.params, self.stats = jsplats.create_from_pcd(
            gate.pts0, np.abs(gate.pts0), 0, capacity=gate.n_splats)
        self.sopt = jsplats.adam_init(self.params)
        self.net = build_splatfields(jcfg.HiddenConfig(**gate.hidden()),
                                     radius=1.0)
        self.fvars = jax.tree.map(jnp.asarray, module_to_flax(port_net))
        self.fopt = jsplats.adam_init(self.fvars["params"])
        self.pipe = jcfg.PipelineConfig(
            tile_size=16, tile_cap=gate.pipe.tile_cap, k_chunk=128)
        key = (self.net, gate.res, len(gate.groups[0]), gate.n_frames,
               gate.pipe.tile_cap)
        if key not in _JAX_STEPS:
            # one program for every seed: the net and the shapes are equal
            _JAX_STEPS[key] = jtrain.make_train_step(
                self.net, jcfg.OptimizationConfig(lambda_mask=0.0,
                                                  lambda_norm=0.01),
                self.pipe, gate.res, gate.res, len(gate.groups[0]), True,
                gate.n_frames, 0)
        self.step_fn = _JAX_STEPS[key]
        self.lrs = jsplats.splat_lr_tree(*SPLAT_LRS)
        self.key = jax.random.PRNGKey(0)

    @property
    def state(self):
        """Host copies of (params, stats, sopt, field params, fopt)."""
        return _np((self.params, self.stats, self.sopt,
                    self.fvars["params"], self.fopt))

    def step(self, b):
        """One step on the port's batch ``b`` (``Gate.batch``)."""
        import jax.numpy as jnp
        jb = jax_batch(b)
        (self.params, self.stats, self.sopt, fp, self.fopt, out,
         self.key) = self.step_fn(
            self.params, self.stats, self.sopt, self.fvars, self.fopt, jb,
            self.lrs, jnp.asarray(FIELD_LR, jnp.float32), self.key)
        self.fvars = dict(self.fvars, params=fp)
        return out

    def psnr(self):
        import jax.numpy as jnp

        from splatfields_tpu.ops.ssim import psnr as psnr_fn
        from splatfields_tpu.render_lib import _render_jit
        g = self.gate
        vals = []
        for v in g.test_v:
            cam = g.cams[v]
            out = _render_jit(
                self.params, self.stats.valid, self.fvars,
                jnp.asarray(cam.world_view_transform),
                jnp.asarray(cam.full_proj_transform),
                jnp.asarray(cam.camera_center),
                jnp.asarray(cam.tanfovx, jnp.float32),
                jnp.asarray(cam.tanfovy, jnp.float32),
                jnp.zeros(3, jnp.float32), jnp.asarray(cam.fid, jnp.float32),
                net=self.net, width=g.res, height=g.res, sh_degree=0,
                field_mode=True, n_frames=g.n_frames, tile_size=16,
                tile_cap=g.pipe.tile_cap, k_chunk=128,
                dup_factor=self.pipe.dup_factor)
            img = jnp.clip(out.color, 0.0, 1.0)
            vals.append(float(psnr_fn(img, jnp.clip(jnp.asarray(
                g.gts[v].numpy()), 0, 1))))
        return float(np.mean(vals))


def port_state_from_jax(state):
    """JAX's host state (``JaxRun.state``) as the port's step arguments."""
    import torch

    from splatfields_torch.interop import (
        adam_state_from_numpy,
        flax_to_state_dict,
        splat_params_from_numpy,
    )
    from splatfields_torch.models import splats
    params, stats, sopt, fparams, fopt = state
    return (splat_params_from_numpy(params, device="cpu"),
            splats.SplatStats(*[torch.tensor(np.asarray(x)) for x in (
                stats.valid, stats.max_radii2d, stats.xyz_gradient_accum,
                stats.denom)]),
            adam_state_from_numpy(sopt, device="cpu"),
            flax_to_state_dict(fparams),
            adam_state_from_numpy(fopt, device="cpu"))


SPLAT_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")


def flat_state(state):
    """{leaf: numpy} of (params, mu, nu) from a port state (tensors) or a
    JAX host state (numpy trees): ``splats.<field>`` and ``field.<state
    dict name>``, each with its ``.mu`` and ``.nu`` twins."""
    from splatfields_torch.interop import flax_to_state_dict
    params, _, sopt, fparams, fopt = state
    out = {}

    def arr(x):
        return np.asarray(x.detach().numpy() if hasattr(x, "detach") else x)

    def field_tree(t):
        if t and not hasattr(next(iter(t.values())), "detach"):
            return {k: v.numpy() for k, v in flax_to_state_dict(t).items()}
        return {k: arr(v) for k, v in t.items()}

    for suffix, tree, ftree in (("", params, fparams),
                                (".mu", sopt.mu, fopt.mu),
                                (".nu", sopt.nu, fopt.nu)):
        for f in SPLAT_FIELDS:
            out[f"splats.{f}{suffix}"] = arr(getattr(tree, f))
        for k, v in field_tree(ftree).items():
            out[f"field.{k}{suffix}"] = v
    return out


def group_of(leaf):
    """The leaf's group: the splat field, or the field's top module."""
    parts = leaf.split(".")
    return ".".join(parts[:2])


def leaf_lr(leaf):
    """A ``flat_state`` parameter leaf's learning rate."""
    if leaf.startswith("splats."):
        from splatfields_torch.models import splats
        return getattr(splats.splat_lr_tree(*SPLAT_LRS), leaf.split(".")[1])
    return FIELD_LR


ROUNDING_LEVEL = 1e-6   # of the step's largest field gradient
JUMP = 1e-6             # relative perturbation of the state for a kink
# normalize() scales its input's rounding by 1 / |x|: tests/test_torch_4d.py
# holds the rotation head's gradients at 10x the others' bound
ROTATION_HEAD = "field.mlp_rotation."


def step_grads(flat, before, b1=0.9):
    """{parameter leaf: the step's gradient} from a ``flat_state`` after
    the step and the one before it (float64): the first moments start
    equal, so g = (mu - b1 mu_before) / (1 - b1)."""
    return {k: (flat[k + ".mu"].astype(np.float64)
                - b1 * before[k + ".mu"].astype(np.float64)) / (1 - b1)
            for k in flat if not k.endswith((".mu", ".nu"))}


def port_step_grads(port, start, b):
    """The port's step from ``start`` -> (state after, ``StepOut``, {leaf:
    the step's gradient as it hands it to ``adam_update``, float64})."""
    from splatfields_torch.models import splats
    seen, adam = [], splats.adam_update

    def spy(params, grads, *args, **kw):
        seen.append(splats.tree_items(grads) if hasattr(grads, "xyz")
                    else grads)
        return adam(params, grads, *args, **kw)

    splats.adam_update = spy
    try:
        state, out = port.run_step(start, b)
    finally:
        splats.adam_update = adam
    g = {f"splats.{k}": v.detach().double().numpy()
         for k, v in seen[0].items()}
    g.update({f"field.{k}": v.detach().double().numpy()
              for k, v in seen[1].items()})
    return state, out, g


def teacher_step(port, j_before, j_after, b):
    """The port's step from JAX's state before an iteration (``j_before``,
    a ``JaxRun.state``) against JAX's state after it (``j_after``) ->
    dict of ``got`` and ``want`` (``flat_state`` of each side after the
    step), ``before`` (JAX's, before), ``g_got`` (the port's gradient, as
    its step hands it to ``adam_update``) and ``g_want`` (JAX's, from its
    moments: ``step_grads``), ``start`` (the port's copy of
    JAX's state before), ``stats`` (the port's and JAX's statistics after)
    and ``out`` (the port's ``StepOut``)."""
    start = port_state_from_jax(j_before)
    state, out, g_got = port_step_grads(port, start, b)
    got, want = flat_state(state), flat_state(j_after)
    before = flat_state(j_before)
    return {"got": got, "want": want, "before": before, "start": start,
            "stats": (state[1], j_after[1]), "g_got": g_got,
            "g_want": step_grads(want, before),
            "counts": (int(j_before[2].count), int(j_before[4].count)),
            "out": out}


def jax_adam(step, leaf, grad):
    """JAX's ``adam_update`` of one leaf from the state before the step,
    fed ``grad`` -> the parameter after it."""
    import jax.numpy as jnp

    from splatfields_tpu.models import splats as jsplats
    count = step["counts"][0 if leaf.startswith("splats.") else 1]
    before = step["before"]
    state = jsplats.AdamState(count=jnp.asarray(count, jnp.int32),
                              mu={"x": jnp.asarray(before[leaf + ".mu"])},
                              nu={"x": jnp.asarray(before[leaf + ".nu"])})
    new, _ = jsplats.adam_update(
        {"x": jnp.asarray(before[leaf])},
        {"x": jnp.asarray(grad.astype(np.float32))}, state, leaf_lr(leaf))
    return np.asarray(new["x"])


def grad_jump(port, step, tb, leaves):
    """{leaf: how far the port's own gradient moves when the state moves
    by the size the two packages' f32 forwards already differ by}: the
    largest change of the field's float64 gradient, and of the whole f32
    step's gradient, when the field's parameters move by +-``JUMP``
    relative (~6e-7 of an attribute). That is a kink: a leaky-ReLU unit
    within rounding of 0 switches its rows' gradients between slopes 1
    and 0.01; in the render, a pixel's alpha at 1/255 or its transmittance
    at 1e-4. A fixed error in the port's gradient does not move with the
    state and is not counted. The float64 field takes its cotangents from
    the port's own f32 render and loss at the state, on a copy of the
    net."""
    import copy

    import torch
    from torch.func import functional_call

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.models.splatfields import time_inputs
    params, stats, _, fparams, _ = step["start"]
    gate = port.gate
    fid = tb["fid"]
    keys = ("means3d", "opacity", "scales", "rotations", "rgb")
    with torch.no_grad():
        attrs32 = train_lib.field_attributes(
            port.deform.net, params.xyz, splats.get_scaling(params),
            stats.valid, fid, gate.n_frames, params=fparams)
    leaf_attrs = {k: attrs32[k].detach().requires_grad_(True) for k in keys}
    attrs = dict(attrs32, **leaf_attrs)
    outs = []
    for v in range(len(tb["tanfovx"])):
        cam = {k: tb[k][v] for k in ("viewmatrix", "projmatrix", "campos",
                                     "tanfovx", "tanfovy")}
        outs.append(train_lib.render_view(attrs, cam, tb["bg"], gate.res,
                                          gate.res, 0, port.pipe))
    loss, _ = train_lib.compute_losses(
        outs, tb, attrs, config.OptimizationConfig(lambda_mask=0.0,
                                                   lambda_norm=0.01),
        attrs["valid"])
    cots = {k: g.double() for k, g in zip(keys, torch.autograd.grad(
        loss, [leaf_attrs[k] for k in keys]))}
    net = copy.deepcopy(port.deform.net).double()
    rng = np.random.RandomState(0)
    shakes = {k: torch.from_numpy(rng.uniform(-1, 1, tuple(v.shape)))
              for k, v in fparams.items()}

    def grads(sign):
        prm = {k: (v.double() * (1 + sign * JUMP * shakes[k]))
               .requires_grad_(True) for k, v in fparams.items()}
        xyz = params.xyz.double()
        ret = functional_call(net, prm, (xyz,), {
            "planes": None, **time_inputs(xyz.shape[0], fid, gate.n_frames,
                                          xyz.device)})
        out = {"means3d": ret["means3D"], "opacity": ret["opacity"][:, 0],
               "scales": ret["scales"], "rotations": ret["rotations"],
               "rgb": ret["rgb"]}
        total = sum((out[k] * cots[k]).sum() for k in keys)
        g = torch.autograd.grad(total, list(prm.values()), allow_unused=True)
        return {k: (torch.zeros_like(p) if x is None else x).numpy()
                for (k, p), x in zip(prm.items(), g)}

    base = grads(0.0)
    jump = dict.fromkeys(leaves, 0.0)
    for sign in (1.0, -1.0):
        moved = grads(sign)
        # the whole f32 step from the moved state: the render's kinks too
        shaken = dict(fparams)
        shaken.update({k: (v.double() * (1 + sign * JUMP * shakes[k]))
                       .float() for k, v in fparams.items()})
        start = step["start"]
        g_step = port_step_grads(port, (*start[:3], shaken, start[4]),
                                 tb)[2]
        for leaf in leaves:
            k = leaf[len("field."):]
            jump[leaf] = max(jump[leaf],
                             float(np.abs(moved[k] - base[k]).max()),
                             float(np.abs(g_step[leaf]
                                          - step["g_got"][leaf]).max()))
    return jump


def hold(port, step, batch):
    """Hold a ``teacher_step`` at the step tests' bounds -> (failures
    [(leaf, what, gap over bound)], notes {kind: [leaves]}).

    - Adam moments: within 1e-5 of the leaf's largest value.
    - Rounding-level leaves (the step's gradient below ``ROUNDING_LEVEL``
      of its largest field gradient in both packages: a conv bias whose
      GroupNorm subtracts it again, a key bias under the softmax, the
      rows behind a zero-initialised layer): the gradient is zero in exact
      arithmetic, and both sides keep it below that level (a leaf below
      it on one side only is compared as any other); their moments and
      parameters are rounding noise that Adam scales to +-lr, so they are
      not compared.
    - A leaf whose moments part past that bound, its gradient small beside
      the step's, is held by the step's gradient at tests/test_torch_4d.py's
      gradient bound: rtol 1e-6 plus 1e-6 of the step's largest field
      gradient (1e-5 for the rotation head, whose ``normalize`` scales
      rounding by 1 / |x|).
    - Else its moments are held to their bound plus 1.5 times how far the
      port's own gradient moves under a perturbation of the state as small
      as the packages' forward gap (``grad_jump``: a kink), carried into
      each moment.
    - Parameters: within rtol 1e-6 plus 1e-4 of the leaf's learning rate
      of JAX's, or, where JAX's own ``adam_update`` fed the port's
      gradient already lands past that bound (Adam divides by a second
      moment near 0), within that bound of it: the gradient is then held
      by the moments, and the update rule is JAX's."""
    got, want = step["got"], step["want"]
    g_got, g_want = step["g_got"], step["g_want"]
    field = [k for k in g_want if k.startswith("field.") and g_want[k].size]
    gmax = max(float(np.abs(g_want[k]).max()) for k in field)
    level = ROUNDING_LEVEL * gmax
    rounding = {k for k in field
                if max(float(np.abs(g_want[k]).max()),
                       float(np.abs(g_got[k]).max())) <= level}
    failures, notes = [], {"rounding level": sorted(rounding), "kink": [],
                           "adam": []}
    moment_fail = set()
    for leaf, w in want.items():
        base = leaf.rsplit(".", 1)[0] if leaf.endswith((".mu", ".nu")) \
            else leaf
        if not w.size or base in rounding or not leaf.endswith(
                (".mu", ".nu")):
            continue
        if float(np.abs(got[leaf] - w).max()) > 1e-5 * float(
                np.abs(w).max()):
            moment_fail.add(base)
    by_grad = set()
    for leaf in moment_fail:
        # tests/test_torch_4d.py's gradient bound: rtol 1e-6 plus 1e-6 of
        # the step's largest gradient, 1e-5 for the rotation head
        tol = 1e-5 if leaf.startswith(ROTATION_HEAD) else 1e-6
        if np.all(np.abs(g_got[leaf] - g_want[leaf])
                  <= tol * np.abs(g_want[leaf]) + tol * gmax):
            by_grad.add(leaf)
    notes["gradient"] = sorted(by_grad)
    moment_fail -= by_grad
    if moment_fail:
        jump = grad_jump(port, step, batch, sorted(moment_fail))
        for leaf in sorted(moment_fail):
            # the gradient's conditioning, carried into each moment
            g = float(np.abs(g_want[leaf]).max())
            extra = {".mu": 0.1 * 1.5 * jump[leaf],
                     ".nu": 0.001 * 1.5 * jump[leaf] * (
                         2 * g + 1.5 * jump[leaf])}
            worst = max(
                float(np.abs(got[leaf + m] - want[leaf + m]).max())
                / (1e-5 * float(np.abs(want[leaf + m]).max()) + e)
                for m, e in extra.items())
            if worst <= 1.0:
                notes["kink"].append(leaf)
            else:
                failures.append((leaf, "moments", worst))
    for leaf, w in want.items():
        if (leaf.endswith((".mu", ".nu")) or not w.size
                or leaf in rounding):
            continue
        bound = 1e-6 * np.abs(w) + 1e-4 * leaf_lr(leaf)
        over = np.abs(got[leaf] - w) > bound
        if not over.any():
            continue
        alt = jax_adam(step, leaf, g_got[leaf])
        adam = np.abs(alt - w) > bound
        bad = over & (~adam | (np.abs(got[leaf] - alt) > bound))
        if bad.any():
            failures.append((leaf, "parameters", float(
                (np.abs(got[leaf] - w) / bound)[bad].max())))
        else:
            notes["adam"].append(leaf)
    return failures, notes


def teacher_gaps(port, j_before, j_after, b):
    """``teacher_step`` and ``hold`` summed up by leaf group -> (rows,
    notes, failures, port's loss, port's dropped count). Per group:
    ``grad``, the largest gap of the step's gradient over the group's
    largest |g|; ``param_lr``, the largest parameter gap in learning
    rates."""
    step = teacher_step(port, j_before, j_after, b)
    failures, notes = hold(port, step, b)
    got, want = step["got"], step["want"]
    rows = {}
    for leaf, g_want in step["g_want"].items():
        if not g_want.size:
            continue
        r = rows.setdefault(group_of(leaf), {
            "grad_gap": 0.0, "grad_max": 0.0, "param_lr": 0.0})
        r["grad_gap"] = max(r["grad_gap"], float(np.abs(
            step["g_got"][leaf] - g_want).max()))
        r["grad_max"] = max(r["grad_max"], float(np.abs(g_want).max()))
        r["param_lr"] = max(r["param_lr"], float(np.abs(
            got[leaf] - want[leaf]).max()) / leaf_lr(leaf))
    for r in rows.values():
        r["grad"] = r.pop("grad_gap") / r["grad_max"] if r["grad_max"] \
            else 0.0
    out = step["out"]
    return (rows, {k: len(v) for k, v in notes.items()}, failures,
            float(out.loss), int(out.loss_dict["bin_dropped"]))


def jax_tree(state):
    """A host state (``JaxRun.state``) as JAX arrays."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, state)


def past_clamp(state, logit):
    """A ``JaxRun.state`` whose splats pass the 0.99 alpha clamp:
    ``logit`` added to the bias of the opacity head's last layer, before
    its sigmoid."""
    import copy
    state = copy.deepcopy(state)
    head = state[3]["mlp_opacity"]
    last = max(head, key=lambda k: int(k.split("_")[1]))
    head[last]["bias"] = (head[last]["bias"] + np.float32(logit)).astype(
        np.float32)
    return state


def clamp_share(port, state, tb):
    """(rows, pairs): over the batch's views and the port's state
    ``state``, the share of the instances the blend applies (a tile's
    rows with an alpha above 1/255 before a pixel's transmittance stops)
    whose alpha reaches the 0.99 clamp at some pixel, and the share of
    the applied (pixel, instance) pairs at the clamp. The pairs' share
    stays under ~0.2% for Gaussian footprints: alpha = opacity exp(power)
    reaches 0.99 only within 0.14 sigma of a centre, and is applied out to
    ~3.3 sigma."""
    import torch

    from splatfields_torch import train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.ops.raster import blend_torch
    from splatfields_torch.ops.raster.binning import bin_gaussians
    from splatfields_torch.ops.raster.preprocess import preprocess
    params, stats, _, fparams, _ = state
    gate = port.gate
    tiles = -(-gate.res // 16)
    clamped = applied = rows_clamped = rows_applied = 0
    with torch.no_grad():
        a = train_lib.field_attributes(
            port.deform.net, params.xyz, splats.get_scaling(params),
            stats.valid, tb["fid"], gate.n_frames, params=fparams)
        for v in range(len(tb["tanfovx"])):
            pre = preprocess(a["means3d"], a["scales"], a["rotations"],
                             a["opacity"], tb["viewmatrix"][v],
                             tb["projmatrix"][v], gate.res, gate.res,
                             tb["tanfovx"][v], tb["tanfovy"][v],
                             colors_precomp=a["rgb"], campos=tb["campos"][v],
                             valid_mask=a["valid"])
            b = bin_gaussians(pre.means2d, pre.depths, pre.radii, tiles,
                              tiles, 16, dup_cap=port.pipe.dup_factor
                              * gate.n_splats)
            pack = blend_torch.pack_attributes(
                pre.means2d, pre.conics, pre.rgb, pre.opacity, pre.depths)
            sorted_pack = pack[torch.clamp_min(b.sorted_id, 0).long()]
            t_full = torch.ones(tiles * tiles, 256)
            for _, _, alpha, _ in blend_torch._chunks(
                    sorted_pack, b.tile_start, b.counts,
                    torch.arange(tiles * tiles, dtype=torch.int32), tiles,
                    16, gate.pipe.tile_cap, 128):
                s = t_full[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
                on = (alpha > 0) & (s >= blend_torch._T_EPS)
                at = on & (alpha >= 0.99)
                applied += int(on.sum())
                clamped += int(at.sum())
                rows_applied += int(on.any(-1).sum())
                rows_clamped += int(at.any(-1).sum())
                t_full = s[:, -1, :]
    return rows_clamped / max(rows_applied, 1), clamped / max(applied, 1)


def same_splats(port, jx):
    """Check that both packages' ``create_from_pcd`` agree, then start the
    port from JAX's splats and statistics, so both loops start bit for bit
    alike. The log scale comes from each package's KNN, both the expanded
    f32 formula |a|^2 + |b|^2 - 2 a.b, whose cancellation turns the
    matmul's summation order into ~1e-4 of a log scale at 20,000 points
    (2.8e-4 at the gate's size); every other leaf is equal."""
    from splatfields_torch.models import splats
    for k, v in splats.tree_items(port.params).items():
        tol = 1e-3 if k == "scaling" else 1e-6
        np.testing.assert_allclose(v.numpy(), np.asarray(
            getattr(jx.params, k)), rtol=0, atol=tol, err_msg=k)
    port.params, port.stats, _, _, _ = port_state_from_jax(
        (_np(jx.params), _np(jx.stats), _np(jx.sopt), jx.fvars["params"],
         _np(jx.fopt)))
    port.sopt = splats.adam_init(port.params)


def run_seed(args, seed):
    """Both loops at one scene seed -> (PSNR rows, teacher rows)."""
    gate = cpu_gate(args.variant, seed, args.res, args.n_true, args.n_splats,
                    args.noise_res, tile_cap=args.tile_cap)
    port = PortRun(gate)
    jx = JaxRun(gate, port.deform.net)
    same_splats(port, jx)
    rows, teacher = [], []
    t0 = time.time()
    for it in range(1, args.iters + 1):
        b = group_batch(gate, (it - 1) % len(gate.groups))
        forced = args.teacher and it % args.teacher == 0
        j_before = jx.state if forced else None
        j_out = jx.step(b)
        p_out = port.step(b)
        if forced:
            gaps, notes, fails, loss, dropped = teacher_gaps(
                port, j_before, jx.state, b)
            worst = max(gaps, key=lambda k: gaps[k]["grad"])
            row = {"seed": seed, "iter": it, "jax_loss": float(j_out.loss),
                   "port_loss": loss,
                   "jax_dropped": int(j_out.loss_dict["bin_dropped"]),
                   "port_dropped": dropped, "worst_grad": gaps[worst]["grad"],
                   "worst_group": worst, "notes": notes,
                   "failures": fails, "gaps": gaps}
            teacher.append(row)
            print(json.dumps({"teacher": row}), flush=True)
        if it % EVAL_EVERY == 0 or it == args.iters:
            pj, pp = jx.psnr(), port.psnr()
            rows.append({"seed": seed, "iter": it, "jax_psnr": pj,
                         "port_psnr": pp, "gap": pp - pj,
                         "jax_loss": float(j_out.loss),
                         "port_loss": float(p_out.loss),
                         "s": time.time() - t0})
            print(json.dumps(rows[-1]), flush=True)
    return rows, teacher


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=("field", "owlii4d", "ngp"),
                    default="field")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--n_splats", type=int, default=512)
    ap.add_argument("--n_true", type=int, default=256)
    ap.add_argument("--noise_res", type=int, default=4)
    ap.add_argument("--tile_cap", type=int, default=TILE_CAP,
                    help="256: the JAX gate's CPU size; 1024 on its TPU")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seeds", default="0",
                    help="comma-separated scene seeds (the net: seed 0)")
    ap.add_argument("--teacher", type=int, default=0,
                    help="every K iterations, the port's step from JAX's "
                         "state")
    ap.add_argument("--threads", type=int, default=1,
                    help="torch intra-op threads")
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(args.threads)
    jax_blend_pallas()
    seeds = [int(s) for s in args.seeds.split(",")]
    finals, teacher = {}, []
    for seed in seeds:
        rows, t = run_seed(args, seed)
        finals[seed] = rows[-1]
        teacher += t
    gaps = [finals[s]["gap"] for s in seeds]
    mean, sd, se = qg.spread(gaps)
    result = {
        "variant": args.variant, "iters": args.iters,
        "size": {"res": args.res, "n_splats": args.n_splats,
                 "n_true": args.n_true, "noise_res": args.noise_res,
                 "tile_cap": args.tile_cap},
        "seeds": seeds,
        "pairs": {s: [finals[s]["jax_psnr"], finals[s]["port_psnr"]]
                  for s in seeds},
        "port_minus_jax_db": gaps, "mean_db": mean, "sd_db": sd,
        "stderr_db": se,
        "agree": bool(abs(mean) <= max(2 * se, 0.3)
                      if not math.isnan(se) else abs(mean) <= 0.3)}
    if teacher:
        worst = max(teacher, key=lambda r: r["worst_grad"])
        result["teacher_worst"] = {k: worst[k] for k in (
            "seed", "iter", "worst_grad", "worst_group")}
        result["teacher_steps"] = len(teacher)
        result["teacher_failed"] = [
            {k: r[k] for k in ("seed", "iter", "failures")}
            for r in teacher if r["failures"]]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
