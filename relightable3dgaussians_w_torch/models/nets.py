"""Appearance networks: port of the JAX package's `models/nets.py`.

`MLPNet` maps a per-image appearance embedding to the environment-light SH
(head B) and the sky SH (head A). Its six `nn.Linear` layers are created in
flax's order (Dense_0 ... Dense_5), so `convert.mlp_state_dict_from_flax` maps
them by index.

`EmbeddingNet` is the convolutional autoencoder that only initializes the
per-image embeddings (`pretrain.py`). It takes and returns NHWC, as the flax
module does, and runs NCHW inside; `convert.embedding_net_from_flax` carries
flax weights across (kernel layouts, the transposed convolutions' flip, the
Dense layers' HWC row order, the running statistics).
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


# ------------------------------------------------------------------ EmbeddingNet

BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5


def fp32_convs():
    """cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); inside this context they run in full float32. Wrap the backward
    too: autograd reads the flag when it runs the convolutions' gradients."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _same_pads(k: int) -> tuple[int, int]:
    """Flax / XLA "SAME" padding of a stride-1 convolution: (before, after)."""
    return (k - 1) // 2, k - 1 - (k - 1) // 2


def _transpose_pads(k: int, s: int) -> tuple[int, int]:
    """XLA's padding of the dilated input of a "SAME" transposed convolution
    (jax.lax.conv_transpose): (before, after)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def _trunc_normal(shape, fan_in: int, scale: float, generator) -> torch.Tensor:
    """Flax's variance-scaling truncated normal: N(0, 1) cut at +-2, scaled to
    variance scale / fan_in."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    w = torch.empty(shape, device=generator.device if generator is not None else "cpu")
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


class FlaxBatchNorm(nn.Module):
    """`flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)` over NCHW channels.

    Training normalizes with the batch statistics and moves the running ones
    as flax does: with the biased batch variance (torch's BatchNorm keeps the
    unbiased one) and momentum 0.9 on the old value."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=BN_EPS)


class EmbeddingNet(nn.Module):
    """Conv autoencoder for the embedding initialization (the reference's
    net_models.py:81-144).

    Encoder: [Conv cf/2, BN, ReLU] x 2 + AvgPool, [Conv cf, BN, ReLU] x 2 +
    AvgPool, Dense -> latent. Decoder: Dense, then transposed convolutions
    (cf stride 2, cf/2, cf/2 stride 2, 3), each with BN and ReLU.
    `pretraining=True` returns the reconstruction, otherwise the latent code;
    `train=True` normalizes with batch statistics and updates the running ones.
    The constructor draws the initial weights as flax's `init_embedding_net`
    does (LeCun-normal convolution kernels, He-normal Dense kernels, zero
    biases, BN scale 1, bias 0, mean 0, var 1), from `generator` (on its
    device); the module is built on the CPU, so move it with `.to(device)`.
    """

    def __init__(self, latent_dim: int = 32, kernel_size: int = 3, channels_f: int = 128,
                 input_shape: int = 256, generator: torch.Generator | None = None):
        super().__init__()
        k, cf = kernel_size, channels_f
        self.latent_dim, self.kernel_size, self.channels_f = latent_dim, k, cf
        self.input_shape = input_shape
        self.s4 = input_shape // 4
        flat = cf * self.s4 * self.s4
        self.conv = nn.ModuleList(nn.Conv2d(i, o, k) for i, o in
                                  ((3, cf // 2), (cf // 2, cf // 2), (cf // 2, cf), (cf, cf)))
        # Transposed convolutions: (in, out, stride); weights [in, out, k, k].
        self.deconv_strides = (2, 1, 2, 1)
        self.deconv = nn.ModuleList(
            nn.ConvTranspose2d(i, o, k, stride=s) for (i, o), s in
            zip(((cf, cf), (cf, cf // 2), (cf // 2, cf // 2), (cf // 2, 3)), self.deconv_strides))
        self.bn = nn.ModuleList(FlaxBatchNorm(n) for n in
                                (cf // 2, cf // 2, cf, cf, cf, cf // 2, cf // 2, 3))
        # Dense rows / columns in flax's HWC order of the flattened feature map.
        self.dense = nn.ModuleList((nn.Linear(flat, latent_dim), nn.Linear(latent_dim, flat)))
        with torch.no_grad():
            for c in self.conv:
                fan_in = c.in_channels * k * k
                c.weight.copy_(_trunc_normal(c.weight.shape, fan_in, 1.0, generator))
                c.bias.zero_()
            for c in self.deconv:   # flax's kernel [k, k, in, out]: fan-in k * k * in
                fan_in = c.in_channels * k * k
                c.weight.copy_(_trunc_normal(c.weight.shape, fan_in, 1.0, generator))
                c.bias.zero_()
            for lin in self.dense:
                lin.weight.copy_(_trunc_normal(lin.weight.shape, lin.in_features, 2.0, generator))
                lin.bias.zero_()

    def _conv(self, i: int, h: torch.Tensor) -> torch.Tensor:
        a, b = _same_pads(self.kernel_size)
        return self.conv[i](F.pad(h, (a, b, a, b)))

    def _deconv(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Flax's `ConvTranspose(padding="SAME")`: the unflipped kernel over the
        zero-stuffed input padded (before, after) = `_transpose_pads`.
        `conv_transpose2d` with padding 0 pads k - 1 on both sides (its weight
        holds the flipped kernel), so the surplus is cropped."""
        k, s = self.kernel_size, self.deconv_strides[i]
        a, b = _transpose_pads(k, s)
        out = self.deconv[i](h)
        n = out.shape[-1]
        return out[..., k - 1 - a:n - (k - 1 - b), k - 1 - a:n - (k - 1 - b)]

    def forward(self, x: torch.Tensor, pretraining: bool = False,
                train: bool = False) -> torch.Tensor:
        """x: [B, S, S, 3] -> latent [B, latent_dim], or with `pretraining` the
        reconstruction [B, S, S, 3]."""
        cf, s4, bn = self.channels_f, self.s4, self.bn
        with fp32_convs():
            h = x.permute(0, 3, 1, 2)
            h = F.relu(bn[0](self._conv(0, h), train))
            h = F.relu(bn[1](self._conv(1, h), train))
            h = F.avg_pool2d(h, 2, 2)
            h = F.relu(bn[2](self._conv(2, h), train))
            h = F.relu(bn[3](self._conv(3, h), train))
            h = F.avg_pool2d(h, 2, 2)
            feat = self.dense[0](h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
            if not pretraining:
                return feat
            d = self.dense[1](feat).reshape(-1, s4, s4, cf).permute(0, 3, 1, 2)
            for i in range(4):
                d = F.relu(bn[4 + i](self._deconv(i, d), train))
            return d.permute(0, 2, 3, 1)

