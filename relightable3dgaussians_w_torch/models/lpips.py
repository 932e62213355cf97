"""LPIPS perceptual metric (v0.1, VGG16 backbone).

Port of the JAX package's `models/lpips.py` (the reference's local
`lpipsPyTorch/`): the ImageNet scaling layer, the 13-convolution VGG16 feature
stack tapped after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, unit
normalization over channels, the learned non-negative 1x1 heads, a spatial mean
and a sum over the taps. Weights come from the same `.npz` schema as the JAX
package's (`feats.{i}.weight/bias`: torchvision `vgg16().features` convolutions
in OIHW; `lins.{k}.weight`: the LPIPS heads), at this package's own default
path; `make_lpips_fn` returns None when the file is absent (metrics then report
`lpips: null`).

The convolutions are `torch.nn.functional.conv2d` (no TPU kernel computed
them). cuDNN runs float32 convolutions in TF32 by default, which keeps about
three decimal digits, so `lpips` turns TF32 off around them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature-extractor conv layout: (layer index in torchvision .features, out_ch).
VGG16_CONVS = [
    (0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512),
]
# Convs whose following relu (at conv index + 1) is a tap point.
VGG16_TAPS = {2: 0, 7: 1, 14: 2, 21: 3, 28: 4}
MAXPOOL_AFTER = {4, 9, 16, 23, 30}

# ImageNet normalization shift/scale of LPIPS's ScalingLayer.
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "_lpips_vgg16.npz")


def available(weights_path: str | None = None) -> bool:
    return os.path.exists(weights_path or DEFAULT_WEIGHTS)


def load_weights(weights_path: str | None = None) -> dict:
    return dict(np.load(weights_path or DEFAULT_WEIGHTS))


def _vgg_features(x: torch.Tensor, w: dict) -> list[torch.Tensor]:
    """x: [N, 3, H, W] in [-1, 1]. Returns the 5 tapped activations [N, C, h, w]."""
    dev = x.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    h = (x - t(SHIFT).view(1, 3, 1, 1)) / t(SCALE).view(1, 3, 1, 1)
    taps = []
    conv_i = 0
    for li in range(30):   # the last max pool (index 30) follows the last tap
        if conv_i < len(VGG16_CONVS) and VGG16_CONVS[conv_i][0] == li:
            h = F.conv2d(h, t(w[f"feats.{li}.weight"]), t(w[f"feats.{li}.bias"]), padding=1)
            conv_i += 1
        elif li in MAXPOOL_AFTER:
            h = F.max_pool2d(h, 2, 2)
        else:
            h = F.relu(h)
            if (li - 1) in VGG16_TAPS:
                taps.append(h)
    return taps


def lpips(img1: torch.Tensor, img2: torch.Tensor, weights: dict) -> torch.Tensor:
    """LPIPS distance of two images, [C, H, W] or [H, W, C], in [0, 1]."""
    def prep(x):
        # The JAX package's layout rule: CHW when the first dim is 1 or 3 and
        # smaller than the last, else HWC.
        if not (x.shape[0] in (1, 3) and x.shape[0] < x.shape[-1]):
            x = x.movedim(-1, 0)
        return (x.to(torch.float32) * 2.0 - 1.0)[None]

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f1 = _vgg_features(prep(img1), weights)
        f2 = _vgg_features(prep(img2), weights)
    total = torch.zeros((), device=img1.device)
    for k, (a, b) in enumerate(zip(f1, f2)):
        a = a * torch.rsqrt(torch.clamp_min(torch.sum(a * a, 1, keepdim=True), 1e-10))
        b = b * torch.rsqrt(torch.clamp_min(torch.sum(b * b, 1, keepdim=True), 1e-10))
        d = (a - b) ** 2
        lin = torch.as_tensor(np.asarray(weights[f"lins.{k}.weight"], np.float32),
                              device=img1.device).reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * torch.clamp_min(lin, 0.0), dim=1))
    return total


def _expected_schema() -> dict:
    """The npz contract (torch OIHW conv shapes)."""
    schema = {}
    in_ch = 3
    for li, out_ch in VGG16_CONVS:
        schema[f"feats.{li}.weight"] = (out_ch, in_ch, 3, 3)
        schema[f"feats.{li}.bias"] = (out_ch,)
        in_ch = out_ch
    for k, ch in enumerate([64, 128, 256, 512, 512]):
        schema[f"lins.{k}.weight"] = (1, ch, 1, 1)
    return schema


EXPECTED_SCHEMA = _expected_schema()


def validate_weights(w: dict):
    """Raise ValueError for an npz that does not match the LPIPS v0.1 (VGG) schema."""
    missing = sorted(set(EXPECTED_SCHEMA) - set(w))
    if missing:
        raise ValueError(f"LPIPS weights npz missing keys: {missing[:5]}...")
    for k, shape in EXPECTED_SCHEMA.items():
        got = tuple(np.shape(w[k]))
        if got != shape:
            raise ValueError(f"LPIPS weights: {k} has shape {got}, want {shape}")


def make_lpips_fn(weights_path: str | None = None):
    """lpips(img1, img2) with the weights loaded, or None if they are absent."""
    if not available(weights_path):
        return None
    w = load_weights(weights_path)
    validate_weights(w)
    return lambda a, b: lpips(a, b, w)


def convert_torch_weights(out_path: str = DEFAULT_WEIGHTS):
    """Write the npz from torchvision's VGG16 and the `lpips` package's heads
    (run once where both and their pretrained weights are installed)."""
    from torchvision.models import vgg16, VGG16_Weights
    import lpips as lpips_pkg

    vgg = vgg16(weights=VGG16_Weights.IMAGENET1K_V1).features
    model = lpips_pkg.LPIPS(net="vgg")
    out = {}
    for li, _ in VGG16_CONVS:
        out[f"feats.{li}.weight"] = vgg[li].weight.detach().numpy()
        out[f"feats.{li}.bias"] = vgg[li].bias.detach().numpy()
    for k in range(5):
        out[f"lins.{k}.weight"] = getattr(model, f"lin{k}").model[-1].weight.detach().numpy()
    np.savez(out_path, **out)
