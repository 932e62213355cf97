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


def mlp_params_to_flax(tree: dict) -> dict:
    """The port's MLP tree ({"dense.i.weight": [out, in], "dense.i.bias"}, as
    parameters, gradients or Adam moments) -> flax layout {"Dense_i":
    {"kernel": [in, out], "bias": [out]}} as numpy."""
    out = {}
    for i in range(6):
        out[f"Dense_{i}"] = {"kernel": tree[f"dense.{i}.weight"].detach().cpu().numpy().T,
                             "bias": tree[f"dense.{i}.bias"].detach().cpu().numpy()}
    return out


def _param_tree(tree: dict, device) -> dict:
    """One JAX param-shaped tree (params, mu or nu) as numpy -> the port's."""
    g = tree["gaussians"]
    g = g._asdict() if hasattr(g, "_asdict") else g
    return {"gaussians": GaussianParams(**{k: _t(g[k], device) for k in GaussianParams._fields}),
            "mlp": {k: v.to(device) for k, v in mlp_state_dict_from_flax(tree["mlp"]).items()},
            "embeddings": _t(tree["embeddings"], device)}


def train_state_from_jax(params: dict, gauss_state, mu: dict, nu: dict, count, step,
                         device="cpu"):
    """The JAX `TrainState`'s params, gauss_state, Adam mu / nu / count and step
    (all numpy, e.g. via `jax.device_get`) -> the port's `TrainState`."""
    from .train_step import AdamState, TrainState

    gs = gauss_state._asdict() if hasattr(gauss_state, "_asdict") else gauss_state
    gauss = GaussianState(**{k: _t(gs[k], device) for k in GaussianState._fields})
    opt = AdamState(_t(count, device), _param_tree(mu, device), _param_tree(nu, device))
    return TrainState(_param_tree(params, device), gauss, opt, _t(step, device))
