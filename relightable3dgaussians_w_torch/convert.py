"""Carry weights from the JAX package across to this one.

The inputs are numpy (callers pull JAX arrays with `jax.device_get` /
`np.asarray`), so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gaussians import GaussianParams, GaussianState


def _t(a, device):
    return torch.as_tensor(np.array(a), device=device)


def gaussians_from_numpy(params: dict, state: dict, device="cpu"):
    """JAX `GaussianParams` / `GaussianState` fields (as numpy, e.g. from
    `params._asdict()`) -> the port's GaussianParams / GaussianState."""
    return (GaussianParams(**{k: _t(params[k], device) for k in GaussianParams._fields}),
            GaussianState(**{k: _t(state[k], device) for k in GaussianState._fields}))


def mlp_state_dict_from_flax(params: dict) -> dict:
    """Flax `MLPNet` params {"Dense_i": {"kernel": [in, out], "bias": [out]}} ->
    the port's `MLPNet` state dict (`dense.i.weight` [out, in], `dense.i.bias`)."""
    sd = {}
    for i in range(6):
        layer = params[f"Dense_{i}"]
        sd[f"dense.{i}.weight"] = torch.as_tensor(np.asarray(layer["kernel"]).T.copy())
        sd[f"dense.{i}.bias"] = torch.as_tensor(np.asarray(layer["bias"]).copy())
    return sd


def embeddings_from_numpy(embeddings, device="cpu") -> torch.Tensor:
    """Per-image appearance embeddings [num_images, dim]."""
    return _t(embeddings, device).to(torch.float32)
