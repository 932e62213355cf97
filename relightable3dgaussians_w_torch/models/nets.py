"""Illumination MLP: port of the JAX package's `models/nets.py` `MLPNet`.

Maps a per-image appearance embedding to the environment-light SH (head B) and
the sky SH (head A). The six `nn.Linear` layers are created in flax's order
(Dense_0 ... Dense_5), so `convert.mlp_state_dict_from_flax` maps them by index.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

KEEP_PROB = 0.8  # Dropout(0.2)


class MLPNet(nn.Module):
    """embedding -> (envlight SH [(deg_envl+1)^2, 3], sky SH [(deg_sky+1)^2, 3]).

    Trunk: Linear(256) + Dropout(0.2) + ReLU, Linear(256) + ReLU, Linear(128) + ReLU;
    sky head: Linear; envlight head: Linear(128) + ReLU + Linear. The dropout
    draws no random numbers itself: the training step passes its keep-mask, and
    without one (serving) the layer passes its input through.
    """

    def __init__(self, sh_degree_envl: int = 4, sh_degree_sky: int = 1,
                 embedding_dim: int = 32, dense_layer_size: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = dense_layer_size
        self.sh_dim_envl = (sh_degree_envl + 1) ** 2
        self.sh_dim_sky = (sh_degree_sky + 1) ** 2
        sizes = [(embedding_dim, d), (d, d), (d, d // 2),
                 (d // 2, self.sh_dim_sky * 3), (d // 2, d // 2),
                 (d // 2, self.sh_dim_envl * 3)]
        self.dense = nn.ModuleList(nn.Linear(i, o) for i, o in sizes)
        # Flax's Dense init (LeCun normal kernel, zero bias), drawn from
        # `generator` so a seed gives the same weights on every device.
        with torch.no_grad():
            for lin in self.dense:
                w = torch.randn(lin.weight.shape, generator=generator)
                lin.weight.copy_(w / math.sqrt(lin.in_features))
                lin.bias.zero_()

    def forward(self, e: torch.Tensor, keep: torch.Tensor | None = None):
        """keep: optional bool keep-mask broadcastable to [..., dense_layer_size]
        for the dropout after the first layer; kept units are scaled by 1/0.8
        (inverted dropout, as flax does)."""
        dense = self.dense
        x = dense[0](e)
        if keep is not None:
            x = torch.where(keep, x / KEEP_PROB, 0.0)
        x = F.relu(x)
        x = F.relu(dense[1](x))
        base = F.relu(dense[2](x))
        sh_sky = dense[3](base).reshape(e.shape[:-1] + (self.sh_dim_sky, 3))
        y = F.relu(dense[4](base))
        sh_envl = dense[5](y).reshape(e.shape[:-1] + (self.sh_dim_envl, 3))
        return sh_envl, sh_sky
