"""Single dataclass config tree: a copy of the JAX package's `config.py`.

Same section names, field names and defaults, so one `a.b=c` command line or
YAML file configures either trainer. Defaults mirror the reference's
`configs/relightable3DG-W.yaml` + optimizer / pipe / dataset groups.

A few runtime fields only steer the TPU package's layout (Pallas chunking,
tile batching, the split dispatch); they load here and have no effect in the
port. The options whose code is not ported yet raise `ValueError` naming their
ROADMAP queue item (`check_ported`) instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    envlight_sh_degree: int = 4
    sky_sh_degree: int = 1
    init_embeddings: bool = False
    init_sh_mlp: bool = False
    embeddings_dim: int = 32
    load_iteration: int | None = None
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
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class DatasetConfig:
    source_path: str = ""
    model_path: str = ""
    test_config_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    logger: bool = True


@dataclass
class RuntimeConfig:
    """Knobs of the trainer with no reference counterpart."""
    pool_capacity: int = 0            # 0 => auto from initial point count
    pool_headroom: float = 8.0        # capacity = headroom * n_init (when auto)
    max_dup: int = 1 << 21            # rasterizer entry budget; 0 = size from
                                      # the scene's measured demand at startup
                                      # (x1.3 headroom; overflow healing still
                                      # grows it)
    max_tiles_per_gauss: int = 64     # TPU layout only: no effect in the port
    lmax_per_tile: int = 2048         # TPU layout only: no effect in the port
    tile_chunk: int = 8               # TPU layout only: no effect in the port
    pallas_chunk: int = 512           # TPU layout only: no effect in the port
    row_intervals: bool = False       # exact per-tile-row ellipse culling in
                                      # binning (image/gradient-free)
    row_intervals_auto: bool = True   # probe the interval-cut ratio at startup
                                      # (trainer._probe_entry_demand) and
                                      # enable row_intervals when the measured
                                      # cut >= 15%
    seed: int = 0
    detect_anomaly: bool = False      # torch.autograd anomaly detection
    data_parallel: int = 0            # > 1: not yet ported (ROADMAP queue 1 item 5)
    coordinator_address: str = ""     # multi-host: not yet ported (queue 1 item 5)
    num_processes: int = 0
    process_id: int = -1
    gauss_shards: int = 1             # > 1: not yet ported (queue 1 item 5)
    use_pallas: bool = True           # TPU layout only: no effect in the port
    split_dispatch: bool = True       # TPU layout only: no effect in the port
    profile_steps: str = ""           # "START:END": torch.profiler trace of those steps
    tensorboard: bool = False         # mirror train scalars/images/histograms to TB
    viewer_port: int = 0              # >0: serve the network viewer during training
    viewer_ip: str = "127.0.0.1"
    viewer_protocol: str = "sibr"     # "sibr" (stock SIBR remote viewer) or "json"
    serve_skip_alpha: float = 1.0 / 255.0  # viewer/serving LOD threshold
                                      # (RasterizerConfig.skip_alpha); 1/255 = exact
    serve_packed_rgb: bool = False    # viewer frames with 12-bit packed R/B
                                      # (RasterizerConfig.packed_rgb, kernel B')
    eval_halffit_views: int = 2       # test views given a short left-half
                                      # embedding fit at eval iterations


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    pipe: PipelineConfig = field(default_factory=PipelineConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


def _apply_override(cfg: Any, dotted: str, value: str):
    obj = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    cur = getattr(obj, parts[-1])
    if isinstance(cur, bool):
        value = value.lower() in ("1", "true", "yes")
    elif isinstance(cur, int):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    elif cur is None:
        value = None if value.lower() in ("none", "null") else int(value)
    setattr(obj, parts[-1], value)


def load_config(overrides: list[str] | None = None, yaml_path: str | None = None) -> Config:
    """Defaults + optional YAML + `a.b=c` overrides. `yaml` is imported only
    when a YAML file is given."""
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        for section, values in data.items():
            sub = getattr(cfg, section)
            for k, v in values.items():
                setattr(sub, k, v)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _apply_override(cfg, key.strip(), val.strip())
    return cfg


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def check_ported(cfg: Config) -> None:
    """Raise ValueError for a setting whose code the port does not have yet."""
    rt = cfg.runtime
    if rt.data_parallel > 1 or rt.gauss_shards > 1 or rt.coordinator_address:
        raise ValueError("runtime.data_parallel / gauss_shards / coordinator_address: "
                         "multi-device training is not yet ported (ROADMAP queue 1 item 5)")
