"""The configuration fields the serving path and the training step read.

A copy of the matching fields of the JAX package's `config.py` (same names,
same defaults).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    envlight_sh_degree: int = 4
    sky_sh_degree: int = 1
    embeddings_dim: int = 32
    specular: bool = True
    fix_sky: bool = False


@dataclass
class OptimizerConfig:
    iterations: int = 40_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 500
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0001
    specular_lr: float = 0.0002
    roughness_lr: float = 0.0002
    metalness_lr: float = 0.0002
    albedo_lr: float = 0.0025
    sky_radius_lr: float = 0.0001
    reg_normal_from_iter: int = 15_000
    lambda_normal: float = 0.05
    lambda_sky_gauss: float = 0.05
    reg_sky_gauss_depth_from_iter: int = 0
    lambda_sky_brdf: float = 0.5
    lambda_scale: float = 100.0
    lambda_envlight: float = 100.0
    embeddings_lr: float = 0.0002
    embednet_pretrain_epochs: int = 100
    optim_embeddings_test_iters: int = 100
    mlp_lr: float = 0.0002


@dataclass
class RuntimeConfig:
    serve_skip_alpha: float = 1.0 / 255.0  # serving LOD threshold
                                           # (RasterizerConfig.skip_alpha);
                                           # 1/255 = exact
    serve_packed_rgb: bool = False         # 12-bit packed R/B entry colors;
                                           # not yet ported (rasterize raises)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
