"""The configuration fields the serving path reads.

A copy of the matching fields of the JAX package's `config.py` (same names,
same defaults); the training fields arrive with the training slice.
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
class RuntimeConfig:
    serve_skip_alpha: float = 1.0 / 255.0  # serving LOD threshold
                                           # (RasterizerConfig.skip_alpha);
                                           # 1/255 = exact
    serve_packed_rgb: bool = False         # 12-bit packed R/B entry colors;
                                           # not yet ported (rasterize raises)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
