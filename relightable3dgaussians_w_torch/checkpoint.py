"""Checkpoint formats shared with the JAX trainer.

* `MLP_weights.npz` holds flax msgpack bytes (`flax.serialization.to_bytes` of
  the MLP's params): nested maps of str -> ndarray, each ndarray a msgpack
  extension of type 1 whose data is the msgpack array (shape, dtype name, raw
  bytes). `mlp_to_bytes` / `mlp_from_bytes` write and read them with the
  `msgpack` package, as flax does, converting between the port's MLP tree and
  flax's layout ({"Dense_i": {"bias", "kernel" [in, out]}}).
* The full-state bundle `state.npz` holds `leaf_0 ... leaf_73` in the order
  `jax.tree_util.tree_flatten` gives the JAX trainer's (params, gauss_state,
  opt_state, step): dict keys sorted, NamedTuple fields in order, optax's
  ScaleByAdamState(count, mu, nu). `state_leaves` / `state_from_leaves` map
  the port's TrainState to and from that list, so either trainer resumes
  from the other's bundle.
"""

from __future__ import annotations

import msgpack
import numpy as np
import torch

from .convert import mlp_params_to_flax, mlp_state_dict_from_flax
from .models.gaussians import GaussianParams, GaussianState

NDARRAY_EXT = 1  # flax's _MsgpackExtType.ndarray


# ------------------------------------------------------------------ msgpack


def _ext_pack(obj):
    """flax's ndarray extension: (shape, dtype name, raw bytes) as msgpack."""
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(NDARRAY_EXT, msgpack.packb(
            (obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True))
    raise TypeError(f"msgpack: unsupported type {type(obj).__name__}")


def _ext_unpack(code: int, data: bytes):
    if code != NDARRAY_EXT:
        raise ValueError(f"msgpack: unsupported extension type {code}")
    shape, dtype, raw = msgpack.unpackb(data, raw=True)
    return np.frombuffer(raw, dtype=np.dtype(dtype.decode())).reshape(shape).copy()


# ------------------------------------------------------------------ MLP weights


def mlp_to_bytes(mlp_tree: dict) -> bytes:
    """The port's MLP parameter tree as flax.serialization.to_bytes writes it."""
    flax_tree = mlp_params_to_flax(mlp_tree)
    tree = {layer: {"bias": v["bias"], "kernel": v["kernel"]} for layer, v in flax_tree.items()}
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def mlp_from_bytes(data: bytes, device="cpu") -> dict:
    """flax msgpack bytes of the MLP's params -> the port's MLP tree."""
    tree = msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False)
    return {k: v.to(device) for k, v in mlp_state_dict_from_flax(tree).items()}


# ------------------------------------------------------------------ full-state bundle

_MLP_LAYERS = [f"Dense_{i}" for i in range(6)]


def _param_leaves(tree: dict) -> list[np.ndarray]:
    """A params-shaped tree (params, mu or nu) in JAX's flatten order:
    embeddings, gaussians (NamedTuple fields), mlp (Dense_i: bias, kernel)."""
    np_ = lambda t: t.detach().cpu().numpy()
    flax_mlp = mlp_params_to_flax(tree["mlp"])
    return ([np_(tree["embeddings"])] + [np_(a) for a in tree["gaussians"]]
            + [a for layer in _MLP_LAYERS for a in (flax_mlp[layer]["bias"],
                                                    flax_mlp[layer]["kernel"])])


def _param_tree(leaves: list, device) -> dict:
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    g = GaussianParams(*[t(a) for a in leaves[1:10]])
    it = iter(leaves[10:22])
    flax_mlp = {layer: {"bias": next(it), "kernel": next(it)} for layer in _MLP_LAYERS}
    mlp = {k: v.to(device) for k, v in mlp_state_dict_from_flax(flax_mlp).items()}
    return {"embeddings": t(leaves[0]), "gaussians": g, "mlp": mlp}


N_PARAM_LEAVES = 1 + len(GaussianParams._fields) + 2 * len(_MLP_LAYERS)     # 22
N_STATE_LEAVES = 3 * N_PARAM_LEAVES + len(GaussianState._fields) + 2       # 74


def state_leaves(state) -> list[np.ndarray]:
    """A TrainState as the JAX trainer's full-state leaves (its dtypes: int32
    Adam count and step)."""
    opt = state.opt_state
    return (_param_leaves(state.params)
            + [a.detach().cpu().numpy() for a in state.gauss_state]
            + [np.asarray(int(opt.count), np.int32)]
            + _param_leaves(opt.mu) + _param_leaves(opt.nu)
            + [np.asarray(int(state.step), np.int32)])


def state_from_leaves(leaves: list, device="cpu"):
    """The JAX trainer's full-state leaves -> the port's TrainState."""
    from .train_step import AdamState, TrainState

    if len(leaves) != N_STATE_LEAVES:
        raise ValueError(f"full-state bundle has {len(leaves)} leaves, expected "
                         f"{N_STATE_LEAVES}")
    p, n_g = N_PARAM_LEAVES, len(GaussianState._fields)
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    params = _param_tree(leaves[:p], device)
    gstate = GaussianState(*[t(a) for a in leaves[p:p + n_g]])
    count = t(leaves[p + n_g]).to(torch.int32)
    mu = _param_tree(leaves[p + n_g + 1:2 * p + n_g + 1], device)
    nu = _param_tree(leaves[2 * p + n_g + 1:3 * p + n_g + 1], device)
    step = t(leaves[-1]).to(torch.int64)
    return TrainState(params, gstate, AdamState(count, mu, nu), step)
