"""Configuration: the four flag groups, the parser and ``cfg_args``.

Counterpart of ``splatfields_tpu/config.py``: ``ModelConfig``,
``PipelineConfig``, ``HiddenConfig`` and ``OptimizationConfig`` with the
JAX package's field names and defaults, so the published run scripts'
command lines parse the same in both packages, and ``cfg_args`` (a dict
repr read with ``ast.literal_eval``) written by either package reads in
the other. ``data_device`` is inert here: a camera's image goes to the
device the entry point runs on.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
from typing import List


def _add_group(parser: argparse.ArgumentParser, cls, shorthand=(),
               sentinel=False):
    """One flag per field. ``sentinel=True`` registers every default as
    None, so only flags given on the command line survive: the render CLI
    lets the stored ``cfg_args`` win over parser defaults."""
    group = parser.add_argument_group(cls.__name__)
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory())
        if isinstance(default, dict):
            continue  # encoder_args: config files only
        flags = [f"--{f.name}"]
        if f.name in shorthand:
            flags.append(f"-{f.name[0]}")
        reg_default = None if sentinel else default
        if f.type in ("bool", bool):
            group.add_argument(*flags, default=reg_default,
                               action="store_true")
        elif isinstance(default, list):
            group.add_argument(*flags, default=reg_default, nargs="+")
        else:
            group.add_argument(*flags, default=reg_default,
                               type=type(default))
    return group


def _extract(cls, args):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items()
                  if k in fields and v is not None})


@dataclasses.dataclass
class ModelConfig:
    """reference ``ModelParams``."""
    sh_degree: int = 3
    bg_path: str = ""
    is_static: bool = False
    vis_geometric: bool = False
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"          # inert (see the module docstring)
    eval: bool = False
    load_time_step: int = 100
    load_every_nth: int = 1
    pc_path: str = ""
    max_num_pts: int = -1
    n_views: int = 6
    num_pts: int = 100_000
    pts_samples: str = "depth"
    train_cam_names: List[str] = dataclasses.field(default_factory=lambda: [
        f"cam_train_{i}" for i in range(10)])
    test_cam_names: List[str] = dataclasses.field(
        default_factory=lambda: ["cam_test"])
    pred_cam_names: List[str] = dataclasses.field(
        default_factory=lambda: ["cam_test"])
    load2gpu_on_the_fly: bool = False
    is_6dof: bool = False

    SHORTHAND = ("source_path", "model_path", "images", "resolution",
                 "white_background")


@dataclasses.dataclass
class PipelineConfig:
    """reference ``PipelineParams`` plus the tile-rasterizer knobs."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    tile_size: int = 16
    tile_cap: int = 1024
    k_chunk: int = 128
    # static duplicated-instance budget = dup_factor * N
    dup_factor: int = 5
    # per-block keep budget of the sharded ring path (not ported yet)
    ring_keep: int | None = None


@dataclasses.dataclass
class HiddenConfig:
    """reference ``ModelHiddenParams``; flags marked inert are declared but
    never consumed upstream and are kept for flag parity."""
    use_isotropic: bool = False
    contract_pts: bool = False        # inert
    rgb_w: int = 128
    deform_weight: float = 1.0
    D: int = 8                        # inert
    W: int = 256                      # inert
    input_ch: int = 3                 # inert
    multires: int = 10                # inert
    num_basis: int = 4
    encoder_type: str = ""
    flow_model: str = "offset"
    layer_strategy: str = "none"
    log2_hashmap_size: int = 20
    n_levels: int = 16
    contract_ngp: bool = False
    color_model: str = "linear"       # inert
    opacity_model: str = "nerf"       # inert
    opacity_ones: bool = False
    opt_pts: bool = False             # inert
    opt_pts_per_frame: bool = False   # inert
    encoder_query_scale: float = 1.0
    use_mlp_encoder: bool = False     # inert
    cat_points: bool = False          # inert
    dont_cat_time: bool = False       # inert
    composition_rank: int = 10
    compression: str = "vm"
    geo_model_disable_pts: bool = False
    use_view_dep_rgb: bool = False
    dct_basis: int = 4
    encoder_args: dict = dataclasses.field(default_factory=dict)
    n_frames: int = 0


@dataclasses.dataclass
class OptimizationConfig:
    """reference ``OptimizationParams``."""
    n_splats: int = -1
    all_training: bool = False
    disable_gaussian_opt: bool = False
    iterations: int = 40_000
    num_views: int = 10
    warm_up: int = -1
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    deform_lr_max_steps: int = 40_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 45_000
    densify_grad_threshold: float = 0.0002
    overwrite_loc: bool = False
    lambda_mask: float = 0.1
    lambda_norm: float = 0.0
    lambda_corr: float = 0.0
    lambda_corr_color: float = 0.0
    # Moran-loss cadence: the corr terms every k-th step, scaled by k
    corr_interval: int = 1
    lambda_norm_mean: float = 0.0
    lambda_depth: float = 0.0
    lambda_opacity: float = 0.0
    lambda_depthl1: float = 0.0
    lambda_gradient: float = 0.0


def build_parser(description="SplatFields (PyTorch)", sentinel=False):
    parser = argparse.ArgumentParser(description=description)
    _add_group(parser, ModelConfig, shorthand=ModelConfig.SHORTHAND,
               sentinel=sentinel)
    _add_group(parser, PipelineConfig, sentinel=sentinel)
    _add_group(parser, HiddenConfig, sentinel=sentinel)
    _add_group(parser, OptimizationConfig, sentinel=sentinel)
    return parser


def extract_configs(args):
    """Namespace -> (ModelConfig, PipelineConfig, HiddenConfig,
    OptimizationConfig), with an absolute source path."""
    model = _extract(ModelConfig, args)
    model.source_path = (os.path.abspath(model.source_path)
                         if model.source_path else "")
    return (model, _extract(PipelineConfig, args),
            _extract(HiddenConfig, args), _extract(OptimizationConfig, args))


def save_cfg_args(model_path: str, args):
    """The run's flags as a dict repr (reference ``train.py:338-339``
    writes a Namespace repr)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(vars(args)))


def _split_top_level(txt: str) -> list[str]:
    parts, cur, depth = [], "", 0
    for ch in txt:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    return parts


def load_cfg_args(model_path: str) -> dict:
    """``cfg_args`` -> dict: a dict repr, or the reference's Namespace
    repr parsed field by field without ``eval``."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        txt = f.read()
    if not txt.startswith("Namespace("):
        return ast.literal_eval(txt)
    out = {}
    for part in _split_top_level(txt[len("Namespace("):-1]):
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            out[k.strip()] = v.strip()
    return out


def get_combined_args(parser: argparse.ArgumentParser, argv=None):
    """The stored run config overridden by the flags given (reference
    ``get_combined_args``), without ``eval``."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    try:
        merged = load_cfg_args(args_cmdline.model_path)
        print("Config file found in", args_cmdline.model_path)
    except (FileNotFoundError, TypeError):
        print("Config file not found")
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)


def merge_yaml_config(args, config_path: str):
    """Merge a YAML config file keyed by group names (reference
    ``utils/params_utils.py``). yaml is imported here only: the GPU
    machine has no yaml, and no published Blender run passes
    ``--configs``."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            "--configs needs the yaml package, which is not installed") from e
    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    for g in ("ModelParams", "ModelHiddenParams", "OptimizationParams",
              "PipelineParams", "ModelConfig", "HiddenConfig",
              "OptimizationConfig", "PipelineConfig"):
        for k, v in cfg.get(g, {}).items():
            setattr(args, k, v)
    return args
