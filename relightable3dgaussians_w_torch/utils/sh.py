"""Real spherical-harmonics math (degrees 0-5): port of the JAX package's
`utils/sh.py`. Everything is float32; the contraction in eval_sh is an
elementwise product and sum, so no TF32 path can reach it (the JAX package pins
these contractions to HIGHEST for the same reason)."""

from __future__ import annotations

import numpy as np
import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)
C5 = (
    -0.6563820568401703,
    8.302649259524165,
    -0.48923829943525043,
    4.793536784973324,
    -0.452946651195697,
    0.1169503224534236,
    -0.452946651195697,
    2.3967683924866,
    -0.48923829943525043,
    2.075662314881041,
    -0.6563820568401701,
)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions [..., 3] -> [..., (deg+1)**2]."""
    if not 0 <= deg <= 5:
        raise ValueError(f"SH degree must be in [0, 5], got {deg}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [C0 * torch.ones_like(x)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg > 2:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg > 3:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    if deg > 4:
        # Same corrected degree-5 entries as the JAX package (m=-5 carries the
        # factor y, m=+1 uses +1).
        out += [
            C5[0] * y * (5 * xx * xx - 10 * yy * xx + yy * yy),
            C5[1] * xy * z * (xx - yy),
            C5[2] * y * (9 * zz - 1) * (3 * xx - yy),
            C5[3] * xy * z * (3 * zz - 1),
            C5[4] * y * (zz * (-14 + 21 * zz) + 1),
            C5[5] * z * (zz * (63 * zz - 70) + 15),
            C5[6] * x * (zz * (21 * zz - 14) + 1),
            C5[7] * z * (xx - yy) * (-1 + 3 * zz),
            C5[8] * x * (xx - 3 * yy) * (-1 + 9 * zz),
            C5[9] * z * (xx * (xx - 6 * yy) + yy * yy),
            C5[10] * x * (xx * (xx - 10 * yy) + 5 * yy * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH-coefficient functions at unit directions.

    Args:
        sh: [..., C, >=(deg+1)**2] coefficients.
        dirs: [..., 3] unit directions, broadcastable against sh's batch dims.
    Returns:
        [..., C]
    """
    n = num_sh_coeffs(deg)
    if sh.shape[-1] < n:
        raise ValueError(f"need {n} SH coefficients for degree {deg}, got {sh.shape[-1]}")
    basis = sh_basis(deg, dirs)                                  # [..., n]
    return torch.sum(sh[..., :n] * basis[..., None, :], dim=-1)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def band_index_per_coeff(deg: int) -> np.ndarray:
    """Static map: flat SH coefficient index -> band l."""
    return np.floor(np.sqrt(np.arange(num_sh_coeffs(deg)))).astype(np.int32)


def gauss_kernel(roughness: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """Per-band Gauss-Weierstrass attenuation exp(-l(l+1) * 0.3 * roughness).

    Args:
        roughness: [..., 1].
    Returns:
        [..., (sh_degree+1)**2]
    """
    l_per_coeff = torch.as_tensor(band_index_per_coeff(sh_degree), dtype=roughness.dtype,
                                  device=roughness.device)
    ll1 = l_per_coeff * (l_per_coeff + 1.0)
    return torch.exp(-ll1 * (0.3 * roughness))


def gamma_correction(rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Clamp to [0,1], add 1e-4, and apply power 1/gamma."""
    rgb = torch.clamp(rgb, 0.0, 1.0) + 1e-4
    return rgb ** (1.0 / gamma)
