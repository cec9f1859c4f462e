"""Moran's-I geometry analysis — ``python -m splatfields_torch.extract_geo``
(counterpart of ``splatfields_tpu/extract_geo.py``).

Reloads a trained run (``cfg_args``, the iteration's PLY and, in field
mode, ``deform.msgpack``, written by either package), computes Moran's I
of the per-splat attributes (scales, rotations, opacity, colour) over
each splat's 5-neighbourhood, and writes ``MoransI_iteration_N.yaml``
into the run directory (reference ``extract_geo.py:145-197``). The file's
text is what ``yaml.safe_dump`` writes for the same dict, without yaml.
With ``--mesh_resolution R`` it also meshes an opacity-weighted gaussian
mixture of the splats on an R^3 grid (``ops/marching.py``) into
``mesh_iteration_N.ply``. A 4-D run (``--load_time_step > 1``) is
analysed at time step 0, as in the JAX CLI.
"""
from __future__ import annotations

import math
import os
import sys

import torch

from splatfields_torch import config as cfg_lib
from splatfields_torch.device import full_f32_math, resolve_device
from splatfields_torch.models import splats as splats_lib
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.models.splatfields import time_inputs
from splatfields_torch.ops import knn as knn_ops
from splatfields_torch.ops.marching import extract_geometry, write_mesh_ply
from splatfields_torch.scene import Scene


@torch.no_grad()
def morans_report(params, stats, deform, n_frames, fid=0.0) -> dict:
    """{"moran_<attr>": Moran's I} of the valid splats: scale, rotation,
    opacity and rgb (the flattened SH matrix in static mode, the field's
    rgb in field mode), over the neighbourhoods of the splats' positions
    (the field's means in field mode; a 4-D field's at time step
    ``fid``)."""
    attrs, pts = moran_inputs(params, stats, deform, n_frames, fid)
    return morans_of(attrs, *knn_ops.query_nn(pts, n_neighbors=5))


@torch.no_grad()
def moran_inputs(params, stats, deform, n_frames, fid=0.0):
    """``morans_report``'s inputs: ({attr: [N, ...]}, positions [N, 3]) of
    the valid splats."""
    valid = stats.valid
    xyz = params.xyz[valid]
    if deform is not None:
        ret = deform.net(xyz, **time_inputs(xyz.shape[0], fid, n_frames,
                                            xyz.device))
        attrs = {
            "scale": ret["scales"] + splats_lib.get_scaling(params)[valid],
            "rotation": ret["rotations"], "opacity": ret["opacity"]}
        if "rgb" in ret:
            attrs["rgb"] = ret["rgb"]
        pts = ret["means3D"]
    else:
        attrs = {
            "scale": splats_lib.get_scaling(params)[valid],
            "rotation": splats_lib.get_rotation(params)[valid],
            "opacity": splats_lib.get_opacity(params)[valid],
            "rgb": splats_lib.get_features(params)[valid].reshape(
                xyz.shape[0], -1),
        }
        pts = xyz
    return attrs, pts


@torch.no_grad()
def morans_of(attrs, w, nn_ix) -> dict:
    """``morans_report`` of ``moran_inputs``' attributes over the
    neighbourhoods (weights, indices) of ``knn.query_nn``."""
    out = {}
    for key in ("scale", "rotation", "opacity", "rgb"):
        if key in attrs:
            feats = attrs[key].reshape(attrs[key].shape[0], -1)
            out[f"moran_{key}"] = float(
                knn_ops.morans_measure(w, feats[nn_ix]))
    return out


@torch.no_grad()
def splat_density_query(params, stats, deform, n_frames, fid=0.0,
                        n_neighbors=8):
    """Density for iso-surface extraction: the opacity-weighted isotropic
    gaussian mixture of the (field-deformed) valid splats, summed over each
    query's ``n_neighbors`` nearest centres -> ``query(pts [M, 3]) -> [M]``
    on the splats' device; a 4-D field at time step ``fid``."""
    valid = stats.valid
    xyz = params.xyz[valid]
    scales = splats_lib.get_scaling(params)[valid]
    opac = splats_lib.get_opacity(params)[valid].reshape(-1)
    if deform is not None:
        ret = deform.net(xyz, **time_inputs(xyz.shape[0], fid, n_frames,
                                            xyz.device))
        xyz = ret["means3D"]
        # the field's scale is added in activated space, as the render does
        scales = torch.clamp_min(scales + ret["scales"], 1e-9)
        opac = ret["opacity"].reshape(-1)
    sigma = torch.clamp_min(scales.mean(dim=-1), 1e-6)   # isotropic
    k = min(n_neighbors, xyz.shape[0])

    @torch.no_grad()
    def query(pts: torch.Tensor) -> torch.Tensor:
        d2, ix = knn_ops.knn_points(pts, xyz, k=k)
        s = sigma[ix]
        return (opac[ix] * torch.exp(-0.5 * d2 / (s * s))).sum(dim=-1)

    return query


def yaml_float(v: float) -> str:
    """A float as PyYAML's ``represent_float`` spells it: ``repr``, lower
    case, ``.0`` before an exponent without a point, ``.nan``/``.inf``."""
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(float(v)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def yaml_text(report: dict) -> str:
    """``yaml.safe_dump`` of a flat {str: float} dict: sorted keys."""
    if not report:
        return "{}\n"
    return "".join(f"{k}: {yaml_float(v)}\n"
                   for k, v in sorted(report.items()))


def build_parser():
    parser = cfg_lib.build_parser("SplatFields (PyTorch) Moran analysis",
                                  sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument(
        "--mesh_resolution", default=0, type=int,
        help="if > 0, also extract a density iso-surface mesh at this grid "
             "resolution (marching tetrahedra, ops/marching.py) and write "
             "mesh_iteration_N.ply")
    parser.add_argument("--mesh_threshold", default=0.5, type=float)
    return parser


def main(argv=None, device=None) -> dict:
    """The CLI -> the Moran report. ``device=None`` means the GPU."""
    full_f32_math()
    dev = resolve_device(device)
    args = cfg_lib.get_combined_args(
        build_parser(), argv if argv is not None else sys.argv[1:])
    model_cfg, _, hidden_cfg, _ = cfg_lib.extract_configs(args)
    n_frames = (model_cfg.load_time_step if model_cfg.load_time_step > 1
                and not model_cfg.is_static else 0)
    hidden_cfg.n_frames = n_frames

    scene = Scene(model_cfg, load_iteration=args.iteration, shuffle=False,
                  device=dev)
    deform = None
    if not model_cfg.is_static:
        deform = DeformModel(hidden_cfg, radius=scene.cameras_extent,
                             device=dev)
        deform.load_weights(model_cfg.model_path, args.iteration)
    report = morans_report(scene.splats, scene.splat_stats, deform, n_frames)
    dst = os.path.join(model_cfg.model_path,
                       f"MoransI_iteration_{scene.loaded_iter}.yaml")
    with open(dst, "w") as f:
        f.write(yaml_text(report))
    print("Saved", dst)
    for k, v in report.items():
        print(k, "=", v)

    if args.mesh_resolution > 0:
        xyz = scene.splats.xyz[scene.splat_stats.valid].cpu().numpy()
        pad = 0.05 * (xyz.max(0) - xyz.min(0) + 1e-6)
        query = splat_density_query(scene.splats, scene.splat_stats, deform,
                                    n_frames)
        verts, tris = extract_geometry(
            xyz.min(0) - pad, xyz.max(0) + pad, args.mesh_resolution,
            args.mesh_threshold, query, device=dev)
        mesh_dst = os.path.join(model_cfg.model_path,
                                f"mesh_iteration_{scene.loaded_iter}.ply")
        write_mesh_ply(mesh_dst, verts, tris)
        print(f"Saved {mesh_dst} ({len(verts)} verts, {len(tris)} faces)")
    return report


if __name__ == "__main__":
    main()
