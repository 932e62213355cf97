"""Initialization pretraining: port of the JAX package's `pretrain.py`.

The embedding autoencoder (the reference's `EmbeddingNet.optimize`,
net_models.py:155-219: 256x256 resize, sigma-0.1 clipped Gaussian noise on the
train split, MSE reconstruction), the encoding pass that gives the per-image
embeddings (relit3DGW_model.py:84-123: encode, L2-normalize) and the supervised
fit of the illumination MLP's envlight head to per-lighting-condition SH priors
(net_models.py:64-78, relit3DGW_model.py:126-136).

Both optimizers are written out in optax's order and formulas, as the JAX
package chains them: `clip_by_global_norm(1.0)`, then `adamw(1e-3, weight_decay
=1e-5)` for the autoencoder and `adam(2e-3)` for the MLP. Random draws (the
autoencoder's initial weights and input noise, the MLP's dropout keep-masks)
come from an explicit `torch.Generator`, or are injected (`noise=`, `keep=`),
so a test can feed JAX's own draws. The epoch order is the JAX package's
`np.random.RandomState(0).permutation(n)` sequence, trailing partial batch
included.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image
from torch.func import functional_call

from .models.nets import KEEP_PROB, EmbeddingNet, MLPNet, fp32_convs
from .train_step import AdamState, adam_update, tree_map

AE_LR, AE_WEIGHT_DECAY = 1e-3, 1e-5
MLP_LR = 2e-3
ADAM_EPS = 1e-8   # optax.adam's default
MAX_GRAD_NORM = 1.0


def _load_resized_images(path: str, size: int = 256) -> np.ndarray:
    """The images of `path` in sorted `os.listdir` order, RGB, resized to
    size x size with PIL's default resampling, as float32 in [0, 1]."""
    imgs = []
    for name in sorted(os.listdir(path)):
        with Image.open(os.path.join(path, name)) as im:
            im = im.convert("RGB").resize((size, size))
            imgs.append(np.asarray(im, np.float32) / 255.0)
    return np.stack(imgs)


def _clip_by_global_norm(grads: dict) -> dict:
    """optax.clip_by_global_norm(1.0): the gradients as they are when their
    global norm is below 1, else t / norm * 1 (no epsilon)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    return {k: torch.where(norm < MAX_GRAD_NORM, g, (g / norm) * MAX_GRAD_NORM)
            for k, g in grads.items()}


def _adam_state(params: dict) -> AdamState:
    dev = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())


def _optax_step(params: dict, grads: dict, opt: AdamState, lr: float,
                weight_decay: float = 0.0):
    """One step of optax.chain(clip_by_global_norm(1), adam or adamw): the
    clipped gradients through `scale_by_adam` (eps 1e-8), the decay
    `weight_decay * p` added to every parameter's update, the update scaled by
    -lr and added. Returns (new params, new Adam state)."""
    updates, opt = adam_update(_clip_by_global_norm(grads), opt, eps=ADAM_EPS)
    if weight_decay:
        updates = tree_map(lambda u, p: u + weight_decay * p, updates, params)
    return tree_map(lambda p, u: p + (-lr) * u, params, updates), opt


def pretrain_embedding_net(generator: torch.Generator, train_images: np.ndarray,
                           test_images: np.ndarray | None = None, num_epochs: int = 100,
                           batch_size: int = 32, latent_dim: int = 32,
                           noise_sigma: float = 0.1, log_every: int = 10,
                           init: dict | None = None, noise=None):
    """Autoencoder pretraining: MSE reconstruction of noisy images, AdamW(1e-3,
    weight decay 1e-5 on every parameter, BN scale and bias included) after a
    global-norm clip at 1 (net_models.py:147-181).

    Args:
        generator: draws the initial weights and the input noise; the net
            trains on its device.
        train_images: [N, S, S, 3] float32 in [0, 1].
        test_images: unused, as in the JAX package.
        init: optional state dict to start from instead of the generator's
            draw (e.g. `convert.embedding_net_from_flax` of flax's init).
        noise: optional per-step standard normal draws [B, S, S, 3] in step
            order, instead of the generator's; the input is
            clip(x + noise_sigma * n, 0, 1).
    Returns:
        (net, losses): the trained `EmbeddingNet` (parameters and running
        statistics) and the per-step losses, one list per epoch.
    """
    dev = generator.device
    net = EmbeddingNet(latent_dim=latent_dim, input_shape=train_images.shape[1],
                       generator=generator)
    if init is not None:
        net.load_state_dict(init)
    net = net.to(dev)
    params = {k: v.detach() for k, v in net.named_parameters()}
    opt = _adam_state(params)
    images = torch.as_tensor(train_images, device=dev)
    noise = iter(noise) if noise is not None else None
    n = len(train_images)
    rng = np.random.RandomState(0)
    history = []
    for epoch in range(num_epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) == 0:
                continue
            batch = images[torch.as_tensor(idx, device=dev)]
            n_std = (torch.as_tensor(np.array(next(noise), np.float32), device=dev)
                     if noise is not None else
                     torch.randn(batch.shape, generator=generator, device=dev))
            noisy = torch.clamp(batch + n_std * noise_sigma, 0.0, 1.0)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            with fp32_convs():
                recon = functional_call(net, leaves, (noisy,), {"pretraining": True,
                                                                "train": True})
                loss = torch.mean((recon - batch) ** 2)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                params, opt = _optax_step({k: v.detach() for k, v in params.items()},
                                          dict(zip(leaves, grads)), opt, AE_LR,
                                          AE_WEIGHT_DECAY)
            losses.append(loss.detach())
        losses = [float(v) for v in losses]
        history.append(losses)
        if (epoch + 1) % log_every == 0:
            print(f"[embednet epoch {epoch + 1}] train mse {np.mean(losses):.5f}")
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(params[k])
    return net, history


def encode_embeddings(net: EmbeddingNet, images: np.ndarray, batch: int = 16) -> torch.Tensor:
    """Latent codes of `images` (running statistics, batches of 16),
    L2-normalized with max(|z|, 1e-12) (relit3DGW_model.py:108-123)."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        z = torch.cat([net(torch.as_tensor(images[i:i + batch], device=dev))
                       for i in range(0, len(images), batch)])
    return z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1, keepdim=True), 1e-12)


def initialize_embeddings_from_dataset(generator: torch.Generator, source_path: str,
                                       latent_dim: int = 32, num_epochs: int = 100,
                                       test: bool = False):
    """The embedding init of a NeRF-OSR-layout dataset: pretrain on
    `train/rgb`, then encode `train/rgb` (or `test/rgb` with `test`).
    Returns (embeddings [N, latent_dim] on the generator's device,
    (net, losses))."""
    train_imgs = _load_resized_images(os.path.join(source_path, "train/rgb"))
    net, losses = pretrain_embedding_net(generator, train_imgs, num_epochs=num_epochs,
                                         latent_dim=latent_dim)
    target = (train_imgs if not test
              else _load_resized_images(os.path.join(source_path, "test/rgb")))
    return encode_embeddings(net, target), (net, losses)


def lighting_condition_of(image_name: str) -> str:
    """Lighting-condition prefix of a NeRF-OSR image name
    (relit3DGW_model.py:129)."""
    return image_name[:3] if image_name.startswith("C") else image_name[:-9]


def sh_prior_targets(image_names: list[str], sh_priors: dict[str, np.ndarray],
                     n_coeff: int) -> np.ndarray:
    """Each image's SH prior [n_coeff, 3]: the first prior name (in the dict's
    order) that contains the image's lighting condition. KeyError if none."""
    targets = []
    for name in image_names:
        lc = lighting_condition_of(name)
        k = next((p for p in sh_priors if lc in p), None)
        if k is None:
            raise KeyError(f"no SH prior for lighting condition {lc!r}")
        targets.append(np.asarray(sh_priors[k])[:n_coeff])
    return np.stack(targets).astype(np.float32)


def initialize_sh_mlp(generator: torch.Generator, mlp: MLPNet, mlp_params: dict,
                      embeddings: torch.Tensor, image_names: list[str],
                      sh_priors: dict[str, np.ndarray], epochs: int = 100,
                      batch_size: int = 32, keep=None) -> dict:
    """Supervised MSE fit of the MLP's envlight SH to per-image priors matched
    by lighting condition (net_models.py:64-78, relit3DGW_model.py:126-136):
    Adam lr 2e-3 after a global-norm clip at 1, dropout on.

    Args:
        generator: draws the dropout keep-masks, on the parameters' device.
        mlp: the port's MLPNet; `mlp_params` its parameters by state-dict name
            (as `TrainState.params["mlp"]`), which are not modified.
        embeddings: [N, D], in the order of `image_names`.
        keep: optional per-step bool keep-masks [B, dense] in step order,
            instead of the generator's.
    Returns:
        The fitted parameters (new tensors).
    """
    dev = embeddings.device
    n_coeff = mlp.sh_dim_envl
    targets = torch.as_tensor(sh_prior_targets(image_names, sh_priors, n_coeff), device=dev)
    params = {k: v.detach() for k, v in mlp_params.items()}
    opt = _adam_state(params)
    keep = iter(keep) if keep is not None else None
    width = mlp.dense[0].out_features
    emb = embeddings.detach()
    n = emb.shape[0]
    rng = np.random.RandomState(0)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=dev)
            k = (torch.as_tensor(np.asarray(next(keep)), device=dev) if keep is not None
                 else torch.rand((len(idx), width), generator=generator, device=dev)
                 < KEEP_PROB)
            leaves = {name: v.requires_grad_(True) for name, v in params.items()}
            sh_out, _ = functional_call(mlp, leaves, (emb[idx],), {"keep": k})
            loss = torch.mean((sh_out - targets[idx]) ** 2)
            # The sky head is not in the loss: zero gradients, as in JAX.
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
            with torch.no_grad():
                params, opt = _optax_step({name: v.detach() for name, v in params.items()},
                                          dict(zip(leaves, grads)), opt, MLP_LR)
    return params
