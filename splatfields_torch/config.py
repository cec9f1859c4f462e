"""Configuration dataclasses of the ported slice.

Counterparts of ``splatfields_tpu/config.py`` ``PipelineConfig``,
``HiddenConfig`` and ``OptimizationConfig`` with identical field names and
defaults, so a config built for one package reads the same in the other.
The argparse surface and the ``cfg_args`` IO come with the ported CLIs.
"""
from __future__ import annotations

import dataclasses


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
